"""CLI + main entry of the PyTorch/CUDA port (counterpart of
llama_box_tpu/cli.py): a subset of its flags, same names and defaults.

    python -m llama_box_tpu_torch.cli -m model.gguf [--device cpu]

A BERT-family file (bert, nomic-bert, jina-bert-v2, new) is loaded by
models/bert.load_bert and serves /v1/embeddings, and /v1/rerank with
--rerank or a `rank` pooling; completions are off for it and under
--embeddings.

LoRA adapters (--lora, --lora-scaled) are merged into the dense weights
at load, or with --lora-per-request kept unmerged for requests' `lora`
scales (models/lora.py); control vectors (--control-vector,
--control-vector-scaled, --control-vector-layer-range) steer the
residual stream (models/control_vector.py).

The server runs on the CUDA card unless `--device cpu` is given; without a
card and without that flag it exits with an error. `build_server(argv)`
returns the engine (started) and the HTTP server (bound, not serving), so
a caller can serve it from a thread.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import signal
import sys
import threading

from .sampling import SamplerParams
from .utils.logging import SRV_INF, SRV_WRN, set_verbosity

VERSION = "0.1.0"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="llama-box-tpu-torch",
        description="OpenAI-compatible inference server (PyTorch/CUDA port)")

    g = p.add_argument_group("general")
    g.add_argument("--version", action="store_true")
    g.add_argument("-v", "--verbose", action="count", default=0)
    g.add_argument("-lv", "--log-verbosity", type=int, default=0)
    g.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (default: the CUDA card)")
    g.add_argument("--system-info", action="store_true",
                   help="print the version, torch's and the cards, and exit")
    g.add_argument("--list-devices", action="store_true",
                   help="as --system-info")

    g = p.add_argument_group("server")
    g.add_argument("--host", default="127.0.0.1")
    g.add_argument("--port", type=int, default=8080)
    g.add_argument("-to", "--timeout", type=int, default=600,
                   help="server read/write timeout in seconds (accepted "
                        "and stored, as in the JAX CLI)")
    g.add_argument("--threads-http", "-np", "--parallel", dest="n_parallel",
                   type=int, default=4, help="number of parallel slots")
    g.add_argument("--metrics", action="store_true", default=True,
                   help="accepted; GET /metrics is always served")
    g.add_argument("--no-prompt-cache", dest="prompt_cache",
                   action="store_false", default=True)
    g.add_argument("--prompt-cache-share-min", type=int, default=32,
                   help="cross-slot prefix sharing: copy KV rows from any "
                        "slot sharing this many more prefix tokens than "
                        "the chosen slot's own cache (-1 disables)")
    g.add_argument("--context-shift", action="store_true", default=True,
                   help="context shift is enabled by default")
    g.add_argument("--no-context-shift", dest="context_shift",
                   action="store_false",
                   help="accepted; context shift stays enabled")
    g.add_argument("-tps", "--tokens-per-second", type=float, default=0.0,
                   help="max decode rate per request; -1 probes at startup")
    g.add_argument("-a", "--alias", "--model-alias", dest="alias",
                   default=None)

    g = p.add_argument_group("model")
    g.add_argument("-m", "--model", required=False,
                   help="path to the GGUF model")
    g.add_argument("-c", "--ctx-size", dest="n_ctx", type=int, default=8192)
    g.add_argument("-ub", "--ubatch-size", dest="n_ubatch", type=int,
                   default=512)
    g.add_argument("--decode-chain", dest="decode_chain", type=int,
                   default=32,
                   help="tokens sampled per device chain on the decode path "
                        "(1 = per-token steps)")
    g.add_argument("--no-decode-pipeline", dest="pipeline_chain",
                   action="store_false", default=True,
                   help="disable speculative dispatch of the next decode "
                        "chain (chain N+1 goes out while chain N's tokens "
                        "are still on their way to the host)")
    g.add_argument("-ctk", "--cache-type-k", default="bf16",
                   choices=["f32", "bf16", "q8_0", "int8"])
    g.add_argument("-ctv", "--cache-type-v", default="bf16",
                   choices=["f32", "bf16", "q8_0", "int8"])
    g.add_argument("--weights-dtype", default="bf16",
                   choices=["bf16", "f32", "quantized"],
                   help="device-resident weight format; 'quantized' keeps "
                        "block-quant projections as per-column int8 (w8a8) "
                        "with bf16 activations, or, when LLAMA_BOX_TPU_PACKED4"
                        ", LLAMA_BOX_TPU_Q4_INT8 or LLAMA_BOX_TPU_Q4_F32SCALES "
                        "is set (read at load time), as GGUF group codes "
                        "(4-bit ones nibble-packed unless Q4_INT8) with bf16 "
                        "scales (f32 under Q4_F32SCALES)")

    # the model overrides of the JAX CLI, applied to the loaded config
    g.add_argument("--rope-scaling", default=None,
                   choices=["none", "linear", "yarn"])
    g.add_argument("--rope-freq-base", type=float, default=0.0)
    g.add_argument("--rope-freq-scale", type=float, default=0.0)
    g.add_argument("--yarn-orig-ctx", type=int, default=0)
    g.add_argument("--rope-scale", type=float, default=0.0,
                   help="RoPE context scale factor N (freq scale = 1/N)")
    g.add_argument("--yarn-ext-factor", type=float, default=None)
    g.add_argument("--yarn-attn-factor", type=float, default=None)
    g.add_argument("--yarn-beta-fast", type=float, default=None)
    g.add_argument("--yarn-beta-slow", type=float, default=None)
    g.add_argument("--attention", default=None,
                   choices=["causal", "non-causal"],
                   help="override the attention type probe")
    g.add_argument("--override-kv", action="append", default=[],
                   help="KEY=TYPE:VALUE metadata overrides")
    # the JAX CLI's other model flags: an alias, and three accepted
    g.add_argument("--no-cache-prompt", dest="prompt_cache",
                   action="store_false", help="alias of --no-prompt-cache")
    g.add_argument("-nr", "--no-repack", action="store_true",
                   help="accepted: the loader picks the layout")
    g.add_argument("--mmap", action="store_true",
                   help="accepted: GGUF tensors are always mmapped")
    g.add_argument("--warmup", action="store_true", default=True,
                   help="accepted: a program is warmed at its first use")
    g.add_argument("--no-warmup", dest="warmup", action="store_false",
                   default=True)

    g = p.add_argument_group("speculative")
    g.add_argument("-md", "--model-draft", default=None,
                   help="draft model GGUF for speculative decoding (loaded "
                        "with the main model's --weights-dtype)")
    g.add_argument("--draft-max", "--draft", "--draft-n", dest="draft_max",
                   type=int, default=8,
                   help="max drafted tokens a verify pass")
    g.add_argument("--draft-min", "--draft-n-min", dest="draft_min",
                   type=int, default=1)
    g.add_argument("--draft-p-min", dest="draft_p_min", type=float,
                   default=0.75)
    g.add_argument("--lookup-ngram-min", type=int, default=0,
                   help="n-gram prompt-lookup drafting (0 = off)")
    g.add_argument("--spec-rounds", dest="spec_rounds", type=int, default=4,
                   help="draft-model draft + verify rounds a device pass")
    g.add_argument("--lookup-min-accept", dest="lookup_min_accept",
                   type=float, default=0.66,
                   help="n-gram drafting holds below this moving "
                        "acceptance (0 = never)")
    g.add_argument("--lookup-probe-every", dest="lookup_probe_every",
                   type=int, default=64)
    # the draft's device placement: one card holds both models
    g.add_argument("-ngld", "--gpu-layers-draft", "--n-gpu-layers-draft",
                   dest="ngld", type=int, default=None, help="ignored")
    g.add_argument("-devd", "--device-draft", default=None, help="ignored")
    g.add_argument("-otd", "--override-tensor-draft", action="append",
                   default=None, help="ignored")
    g.add_argument("-cmoed", "--cpu-moe-draft", action="store_true",
                   help="ignored")
    g.add_argument("-ncmoed", "--n-cpu-moe-draft", type=int, default=None,
                   help="ignored")

    g = p.add_argument_group("embedding")
    g.add_argument("--embeddings", "--embedding", dest="embeddings",
                   action="store_true", default=False,
                   help="serve embeddings only (completions off)")
    g.add_argument("--rerank", "--reranking", dest="rerank",
                   action="store_true", default=False,
                   help="serve /v1/rerank")
    g.add_argument("--pooling", default=None,
                   choices=["none", "mean", "cls", "last", "rank"],
                   help="the embedding pool mode of a llama-family model")

    g = p.add_argument_group("multimodal")
    g.add_argument("--mmproj", default=None,
                   help="a vision/audio projector GGUF: image_url and "
                        "input_audio chat parts")
    g.add_argument("--visual-max-image-size", type=int, default=0,
                   help="downscale images so the long side <= N px")
    g.add_argument("--visual-max-image-cache", "--max-projected-cache",
                   dest="visual_max_image_cache", type=int, default=0,
                   help="projected-embedding LRU entries (0: 8)")

    # accepted for llama-box command lines, as in the JAX CLI: ignored
    # (one card holds the whole model) or mapped; the port keeps its own
    # --device, so llama-box's -dev is a flag of its own here
    g = p.add_argument_group("compat (accepted for llama-box command-line "
                             "compatibility; mapped or ignored)")
    g.add_argument("-ngl", "--gpu-layers", "--n-gpu-layers", dest="ngl",
                   type=int, default=None,
                   help="ignored: every layer runs on the card")
    g.add_argument("-ts", "--tensor-split", default=None, help="ignored")
    g.add_argument("-sm", "--split-mode", default=None,
                   choices=["none", "layer", "row"], help="ignored")
    g.add_argument("-mg", "--main-gpu", type=int, default=None,
                   help="ignored")
    g.add_argument("-dev", dest="dev", default=None,
                   help="ignored (--device picks cuda or cpu)")
    g.add_argument("--rpc", default=None, help="ignored")
    g.add_argument("-fa", "--flash-attn", action="store_true", default=None,
                   help="always on: the flash kernels are the attention")
    g.add_argument("--no-flash-attn", action="store_true",
                   help="ignored: the flash kernels are the only attention "
                        "path of the card")
    g.add_argument("--no-mmap", action="store_true", help="ignored")
    g.add_argument("--mlock", action="store_true", help="ignored")
    g.add_argument("--swa-full", action="store_true", help="ignored")
    g.add_argument("-kvu", "--kv-unified", action="store_true",
                   help="accepted: the KV cache is already one buffer")
    g.add_argument("-t", "--threads", type=int, default=None,
                   help="host CPU threads (sets OMP_NUM_THREADS, as the "
                        "JAX CLI does)")
    g.add_argument("-tb", "--threads-batch", type=int, default=None,
                   help="accepted")
    for flag in ("--cpu-mask", "--cpu-mask-batch", "--cpu-range",
                 "--cpu-range-batch", "--numa"):
        g.add_argument(flag, default=None, help="ignored")
    for flag in ("--cpu-strict", "--cpu-strict-batch", "--poll",
                 "--poll-batch", "--prio", "--prio-batch"):
        g.add_argument(flag, type=int, default=None, help="ignored")
    g.add_argument("-nkvo", "--no-kv-offload", action="store_true",
                   help="ignored: the KV cache lives on the card")
    g.add_argument("-ot", "--override-tensor", action="append",
                   default=None, help="ignored")
    g.add_argument("-cmoe", "--cpu-moe", action="store_true",
                   help="ignored")
    g.add_argument("-ncmoe", "--n-cpu-moe", type=int, default=None,
                   help="ignored")
    g.add_argument("-b", "--batch-size", dest="n_batch", type=int,
                   default=2048, help="accepted: prompts run in -ub chunks")
    g.add_argument("--cache-reuse", type=int, default=0,
                   help="accepted: prefix prompt-cache reuse is always on")
    g.add_argument("-dt", "--defrag-thold", type=float, default=None,
                   help="accepted: slot KV is defragmented by shifting")
    g.add_argument("--conn-idle", type=int, default=60, help="accepted")
    g.add_argument("--conn-keepalive", type=int, default=15,
                   help="accepted")
    g.add_argument("--slot-save-path", default=None, help="accepted")
    g.add_argument("--images", action="store_true", default=None,
                   help="accepted")
    g.add_argument("--log-colors", action="store_true", help="accepted")
    g.add_argument("--log-verbose", dest="log_verbose_flag",
                   action="store_true", help="alias of high --log-verbosity")
    g.add_argument("--verbosity", dest="log_verbosity", type=int,
                   default=0, help="alias of -lv")
    g.add_argument("--usage", action="help",
                   help="print usage (alias of --help)")
    g.add_argument("--list-buffer-types", action="store_true",
                   help="list device memory kinds and exit")
    g.add_argument("--rpc-server-host", default=None, help="unsupported")
    g.add_argument("--rpc-server-port", type=int, default=None,
                   help="unsupported")
    for flag in ("--rpc-server-main-gpu", "--rpc-server-threads",
                 "--rpc-server-reserve-memory"):
        g.add_argument(flag, type=int, default=None, help="ignored")
    g.add_argument("--rpc-server-cache", action="store_true",
                   help="ignored")
    g.add_argument("--rpc-server-cache-dir", default=None, help="ignored")

    g = p.add_argument_group("completion")
    g.add_argument("--temp", type=float, default=0.8)
    g.add_argument("--top-k", type=int, default=40)
    g.add_argument("--top-p", type=float, default=0.95)
    g.add_argument("--min-p", type=float, default=0.05)
    g.add_argument("--typical", dest="typ_p", type=float, default=1.0)
    g.add_argument("--repeat-penalty", type=float, default=1.0)
    g.add_argument("--repeat-last-n", type=int, default=64)
    g.add_argument("--frequency-penalty", type=float, default=0.0)
    g.add_argument("--presence-penalty", type=float, default=0.0)
    g.add_argument("--mirostat", type=int, default=0, choices=[0, 1, 2])
    g.add_argument("--mirostat-ent", dest="mirostat_tau", type=float,
                   default=5.0, help="mirostat target entropy tau")
    g.add_argument("--mirostat-lr", dest="mirostat_eta", type=float,
                   default=0.1, help="mirostat learning rate eta")
    g.add_argument("--dry-multiplier", type=float, default=0.0)
    g.add_argument("--dry-base", type=float, default=1.75)
    g.add_argument("--dry-allowed-length", type=int, default=2)
    g.add_argument("--dry-penalty-last-n", type=int, default=-1)
    g.add_argument("--dry-sequence-breaker", action="append", default=None,
                   help="DRY sequence breaker (repeatable; 'none' clears; "
                        "default: newline ':' '\"' '*')")
    g.add_argument("--dynatemp-range", type=float, default=0.0)
    g.add_argument("--dynatemp-exp", dest="dynatemp_exponent", type=float,
                   default=1.0)
    g.add_argument("--xtc-probability", type=float, default=0.0)
    g.add_argument("--xtc-threshold", type=float, default=0.10)
    g.add_argument("--top-nsigma", type=float, default=-1.0)
    g.add_argument("-l", "--logit-bias", action="append", default=[],
                   metavar="TOKEN_ID(+/-)BIAS",
                   help="server default logit bias, e.g. 29871+1.5 "
                        "or 29871-inf (repeatable)")
    g.add_argument("--grammar", default="",
                   help="server default GBNF grammar")
    g.add_argument("--grammar-file", default=None)
    g.add_argument("-j", "--json-schema", default=None,
                   help="server default JSON schema (converted to GBNF)")
    g.add_argument("--samplers", "--sampling-seq", dest="samplers",
                   default=None,
                   help="sampler selection + order, ';'-separated; a "
                        "non-canonical order samples on the host")
    g.add_argument("-r", "--reverse-prompt", action="append", default=[],
                   help="stop strings added to every request")
    g.add_argument("-sp", "--special", action="store_true", default=False,
                   help="accepted and ignored, as in the JAX CLI")
    g.add_argument("-e", "--escape", action="store_true", default=True,
                   help="process escape sequences (accepted; server "
                        "prompts arrive via JSON which already unescapes)")
    g.add_argument("--no-escape", dest="escape", action="store_false")
    g.add_argument("-s", "--seed", type=int, default=-1,
                   help="accepted and ignored, as in the JAX CLI (a "
                        "request's own seed seeds its draws)")
    g.add_argument("-n", "--predict", dest="n_predict", type=int, default=-1)
    g.add_argument("--keep", dest="n_keep", type=int, default=0,
                   help="accepted and stored; a request's own n_keep sets "
                        "what a context shift keeps")
    g.add_argument("--jinja", action="store_true", default=True)
    g.add_argument("--no-jinja", dest="jinja", action="store_false")
    g.add_argument("--chat-template", default=None)
    g.add_argument("--chat-template-file", default=None)
    g.add_argument("--chat-template-kwargs", default=None,
                   help="JSON object merged into the template context")
    # Parsed and ignored, as in the JAX package: reasoning blocks are
    # always split when the chat template has markers.
    g.add_argument("--enable-reasoning", dest="enable_reasoning",
                   action="store_true", default=True)
    g.add_argument("--no-enable-reasoning", dest="enable_reasoning",
                   action="store_false", help="accepted and ignored")
    g.add_argument("--reasoning-in-content", dest="reasoning_in_content",
                   action="store_true", default=False,
                   help="accepted and ignored")
    g.add_argument("--no-reasoning-in-content", dest="reasoning_in_content",
                   action="store_false")

    g = p.add_argument_group("lora")
    g.add_argument("--lora", action="append", default=[],
                   help="LoRA adapter GGUF (repeatable)")
    g.add_argument("--lora-scaled", action="append", nargs=2, default=[],
                   metavar=("PATH", "SCALE"))
    g.add_argument("--lora-init-without-apply", action="store_true",
                   default=False)
    g.add_argument("--lora-per-request", action="store_true", default=False,
                   help="keep adapters unmerged; requests pick scales via "
                        "the 'lora' field (slots batch together regardless)")

    g = p.add_argument_group("control vectors")
    g.add_argument("--control-vector", action="append", default=[],
                   help="control vector GGUF added to the residual stream "
                        "(repeatable)")
    g.add_argument("--control-vector-scaled", action="append", nargs=2,
                   default=[], metavar=("PATH", "SCALE"))
    g.add_argument("--control-vector-layer-range", nargs=2, type=int,
                   default=None, metavar=("START", "END"),
                   help="1-based inclusive layer range to steer")
    return p


_KV = {"f32": "float32", "bf16": "bfloat16", "q8_0": "int8", "int8": "int8"}


def _default_sampling(args) -> SamplerParams:
    brks = args.dry_sequence_breaker
    if brks is None:
        brks = ("\n", ":", "\"", "*")
    elif brks == ["none"]:
        brks = ()
    samplers = ()
    if args.samplers:
        from .sampling import sampler_types_from_names
        samplers = sampler_types_from_names(
            args.samplers.replace(",", ";").split(";"))
    return SamplerParams(
        samplers=samplers,
        temp=args.temp, top_k=args.top_k, top_p=args.top_p,
        min_p=args.min_p, typ_p=args.typ_p,
        penalty_repeat=args.repeat_penalty,
        penalty_last_n=args.repeat_last_n,
        penalty_freq=args.frequency_penalty,
        penalty_present=args.presence_penalty,
        xtc_probability=args.xtc_probability,
        xtc_threshold=args.xtc_threshold,
        top_n_sigma=args.top_nsigma,
        dynatemp_range=args.dynatemp_range,
        dynatemp_exponent=args.dynatemp_exponent,
        mirostat=args.mirostat, mirostat_tau=args.mirostat_tau,
        mirostat_eta=args.mirostat_eta,
        dry_multiplier=args.dry_multiplier, dry_base=args.dry_base,
        dry_allowed_length=args.dry_allowed_length,
        dry_penalty_last_n=args.dry_penalty_last_n,
        dry_sequence_breakers=tuple(brks),
        logit_bias=_parse_logit_bias_flags(args.logit_bias))


def _parse_logit_bias_flags(entries: list[str]) -> dict[int, float]:
    """TOKEN_ID(+/-)BIAS, e.g. 29871+1.5, 29871-0.5, 29871-inf
    (engine_param.hpp --logit-bias); a malformed entry is ignored with a
    warning, as in the JAX CLI."""
    out: dict[int, float] = {}
    for e in entries:
        m = re.match(r"^(\d+)([+-])(inf|[0-9.]+)$", e.strip())
        if not m:
            SRV_WRN("main", "--logit-bias %r is malformed (want "
                    "TOKEN_ID+BIAS or TOKEN_ID-inf); ignored", e)
            continue
        tid, sign, val = int(m.group(1)), m.group(2), m.group(3)
        bias = float("-inf") if val == "inf" else float(val)
        out[tid] = -bias if sign == "-" and val != "inf" else bias
    return out


def _default_grammar_text(args) -> str | None:
    if args.grammar:
        return args.grammar
    if args.grammar_file:
        with open(args.grammar_file) as f:
            return f.read()
    if args.json_schema:
        from .grammar import json_schema_to_grammar
        return json_schema_to_grammar(json.loads(args.json_schema))
    return None


def _apply_compat(args) -> None:
    """The compat flags that do something, as the JAX CLI's main applies
    them: --log-verbose, -t (OMP_NUM_THREADS), the warnings of the ignored
    placement flags."""
    if args.log_verbose_flag:
        args.log_verbosity = max(args.log_verbosity, 3)
    set_verbosity(args.verbose + args.log_verbosity)
    if args.threads:
        os.environ.setdefault("OMP_NUM_THREADS", str(args.threads))
    for flag, val in (("-ngl", args.ngl), ("--tensor-split",
                                           args.tensor_split),
                      ("--split-mode", args.split_mode),
                      ("--main-gpu", args.main_gpu), ("-dev", args.dev),
                      ("--rpc", args.rpc),
                      ("--no-flash-attn", args.no_flash_attn or None),
                      ("--rpc-server-host", args.rpc_server_host)):
        if val is not None:
            SRV_WRN("main", "%s has no effect on the port (one card holds "
                    "the whole model)", flag)


def config_overrides(args) -> dict:
    """The model config fields the command line overrides (the JAX CLI's
    rope, YaRN and attention-type overrides)."""
    over: dict = {}
    if args.rope_scaling:
        over["rope_scaling_type"] = args.rope_scaling
    if args.rope_freq_base > 0:
        over["rope_freq_base"] = args.rope_freq_base
    if args.rope_freq_scale > 0:
        over["rope_freq_scale"] = args.rope_freq_scale
    elif args.rope_scale > 0:
        over["rope_freq_scale"] = 1.0 / args.rope_scale
    if args.yarn_orig_ctx > 0:
        over["rope_orig_ctx"] = args.yarn_orig_ctx
    for name in ("yarn_ext_factor", "yarn_attn_factor", "yarn_beta_fast",
                 "yarn_beta_slow"):
        if getattr(args, name) is not None:
            over[name] = getattr(args, name)
    if args.attention:
        over["causal"] = args.attention == "causal"
    return over


def list_buffer_types() -> None:
    """--list-buffer-types: the card's memory (torch's view of it)."""
    import torch
    print(f"llama-box-tpu-torch {VERSION}")
    if not torch.cuda.is_available():
        print("  cpu (no CUDA card)")
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        prop = torch.cuda.get_device_properties(i)
        print(f"  {i}: {prop.name} (cuda) hbm={prop.total_memory / 1e9:.1f}GB")


def system_info() -> None:
    """--system-info / --list-devices: the version, torch's, and the
    cards (the JAX CLI prints jax's backend and devices)."""
    import torch
    print(f"llama-box-tpu-torch {VERSION}")
    print(f"torch {torch.__version__}; cuda={torch.version.cuda}; "
          f"available={torch.cuda.is_available()}")
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        print(f"  {i}: {torch.cuda.get_device_name(i)} (cuda)")


def build_server(argv: list[str]):
    """Parse argv, load the model and start the engine; return
    (engine, server) with the server bound but not serving. Raises
    SystemExit on a bad command line (no model, --jinja without jinja2,
    unequal cache types) and RuntimeError when CUDA was asked for (the
    default) and is not available."""
    import torch

    from .gguf import GGUFFile
    from .models.bert import BERT_ARCHS, load_bert
    from .models.loader import load_model, parse_kv_overrides
    from .server.chat import ChatTemplates, jinja_available
    from .server.engine import Engine, EngineConfig, resolve_device
    from .server.http import HTTPServer
    from .tokenizer import Tokenizer

    args = build_parser().parse_args(argv)
    _apply_compat(args)
    if not args.model:
        raise SystemExit("error: -m/--model is required")
    if args.jinja and not jinja_available():
        raise SystemExit("error: --jinja (the default) needs the jinja2 "
                         "package, which is not installed; pass --no-jinja "
                         "to use the builtin chat templates")
    if _KV[args.cache_type_k] != _KV[args.cache_type_v]:
        raise SystemExit("error: -ctk and -ctv must name the same cache "
                         "type")
    device = resolve_device(args.device)

    SRV_INF("main", "loading %s on %s", args.model, device)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32,
             "quantized": torch.bfloat16}[args.weights_dtype]
    with GGUFFile(args.model) as g:
        arch = g.architecture
        tokenizer = Tokenizer.from_gguf(g)
    quantized = args.weights_dtype == "quantized"
    is_bert = arch in BERT_ARCHS
    if is_bert:
        # every tensor dequantized to the activation dtype, as the JAX CLI
        cfg, params = load_bert(args.model, dtype=dtype, device=device)
        if args.rerank or cfg.pooling == "rank":
            cfg = dataclasses.replace(cfg, pooling="rank")
    else:
        cfg, params = load_model(
            args.model, dtype=dtype, device=device, quantized=quantized,
            metadata_overrides=parse_kv_overrides(args.override_kv))
        if args.pooling:    # --pooling overrides the embedding pool mode
            cfg = dataclasses.replace(cfg, pooling=args.pooling)
        over = config_overrides(args)
        if over:
            cfg = dataclasses.replace(cfg, **over)
            SRV_INF("main", "config overrides: %s", over)
        if args.control_vector or args.control_vector_scaled:
            params["cvec"] = load_cvec(args, cfg, dtype, device)
    if is_bert and (args.lora or args.lora_scaled or args.control_vector
                    or args.control_vector_scaled):
        raise SystemExit("error: LoRA adapters and control vectors need a "
                         "decoder; a BERT encoder takes neither")
    adapters, lora_dynamic = [], 0
    if args.lora or args.lora_scaled:
        from .models.lora import apply_lora, load_lora, stack_dynamic
        adapters = [load_lora(pth, 1.0) for pth in args.lora]
        adapters += [load_lora(pth, float(sc))
                     for pth, sc in args.lora_scaled]
        if args.lora_per_request:
            lora_dynamic = stack_dynamic(params, cfg, adapters)
        elif not args.lora_init_without_apply:
            params = apply_lora(params, cfg, adapters)
    draft = None
    if args.model_draft:
        SRV_INF("main", "loading draft model %s", args.model_draft)
        draft = load_model(args.model_draft, dtype=dtype, device=device,
                           quantized=quantized)
    template = args.chat_template
    if args.chat_template_file:
        with open(args.chat_template_file) as f:
            template = f.read()
    ecfg = EngineConfig(
        n_slots=max(1, args.n_parallel), n_ctx=args.n_ctx,
        n_ubatch=args.n_ubatch, kv_dtype=_KV[args.cache_type_k],
        n_keep_default=args.n_keep, prompt_cache=args.prompt_cache,
        cache_share_min=args.prompt_cache_share_min,
        decode_chain=max(1, args.decode_chain),
        pipeline_chain=args.pipeline_chain, draft_max=args.draft_max,
        draft_min=args.draft_min, draft_p_min=args.draft_p_min,
        lookup_ngram_min=args.lookup_ngram_min,
        lookup_min_accept=args.lookup_min_accept,
        lookup_probe_every=args.lookup_probe_every,
        spec_rounds=max(1, args.spec_rounds))
    multimodal = None
    if args.mmproj:
        if is_bert:
            raise SystemExit("error: --mmproj needs a decoder; a BERT "
                             "encoder serves embeddings and rerank")
        multimodal = load_multimodal(args.mmproj, cfg.n_embd, device)
        if args.visual_max_image_size > 0:
            multimodal.max_image_size = args.visual_max_image_size
        if args.visual_max_image_cache > 0:
            multimodal.max_cache = args.visual_max_image_cache
    engine = Engine(cfg, params, tokenizer, ecfg, device=str(device),
                    draft=draft)
    if lora_dynamic:
        engine.configure_lora(
            lora_dynamic, [0.0 if args.lora_init_without_apply else a.scale
                           for a in adapters])
    engine.start()
    max_tps = args.tokens_per_second
    if max_tps < 0:     # -1: probe the decode rate (reference -tps -1)
        SRV_INF("main", "probing decode tokens/sec ...")
        max_tps = engine.probe_decode_tps()
        SRV_INF("main", "decode rate: %.1f tok/s", max_tps)
    app = HTTPServer(
        engine, model_name=args.alias or args.model.rsplit("/", 1)[-1],
        defaults=_default_sampling(args),
        chat_templates=ChatTemplates(tokenizer, template, args.jinja),
        default_max_tokens=args.n_predict,
        default_stop=tuple(args.reverse_prompt),
        max_tps=max_tps, default_grammar=_default_grammar_text(args),
        chat_template_kwargs=(json.loads(args.chat_template_kwargs)
                              if args.chat_template_kwargs else None),
        capabilities={"completion": not is_bert and not args.embeddings,
                      # a recurrent model has no embeddings forward (the
                      # engine refuses the task too, as in JAX)
                      "embedding": not cfg.recurrent,
                      "reranking": args.rerank
                      or (is_bert and cfg.pooling == "rank")},
        multimodal=multimodal,
        lora_adapters=[{"id": i, "path": a.path,
                        "scale": 0.0 if args.lora_init_without_apply
                        else a.scale} for i, a in enumerate(adapters)])
    return engine, app.make_server(args.host, args.port)


def load_cvec(args, cfg, dtype, device):
    """The control vectors of --control-vector / --control-vector-scaled,
    summed and cut to --control-vector-layer-range (models/
    control_vector.py), as one [L, E] tensor of the weights' dtype on
    `device` (the JAX CLI's params["cvec"])."""
    import torch

    from .models.control_vector import combine_control_vectors
    entries = [(pth, 1.0) for pth in args.control_vector]
    entries += [(pth, float(sc)) for pth, sc in args.control_vector_scaled]
    lr = (tuple(args.control_vector_layer_range)
          if args.control_vector_layer_range else None)
    cv = combine_control_vectors(entries, cfg.n_layers, cfg.n_embd,
                                 layer_range=lr)
    return torch.from_numpy(cv).to(device, dtype)


def load_multimodal(path: str, n_embd: int, device):
    """An mmproj's towers as a MultimodalProcessor on `device` (f32, as
    the JAX CLI loads them): the vision tower, and the audio tower when
    the file has `clip.has_audio_encoder`; each tower's projection must
    be the model's embedding width (JAX checks the vision one even where
    the file has no vision tower)."""
    from .gguf import GGUFFile
    from .models.clip import load_clip
    from .server.multimodal import MultimodalProcessor
    ccfg, cparams = load_clip(path, device=device)
    acfg = aparams = None
    with GGUFFile(path) as g:
        has_audio = bool(g.metadata.get("clip.has_audio_encoder"))
    if has_audio:
        from .models.audio import load_audio_tower
        acfg, aparams = load_audio_tower(path, device=device)
    dims = ([ccfg.proj_dim] if cparams.get("patch_embd") is not None
            else []) + ([acfg["proj_dim"]] if acfg else [])
    if any(d != n_embd for d in dims) or not dims:
        raise SystemExit(f"error: mmproj projection dims {dims} != model "
                         f"embedding dim {n_embd}")
    return MultimodalProcessor(ccfg, cparams, audio_cfg=acfg,
                               audio_params=aparams)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--version" in argv:
        print(f"llama-box-tpu-torch {VERSION}")
        return 0
    if "--list-buffer-types" in argv:
        list_buffer_types()
        return 0
    if "--system-info" in argv or "--list-devices" in argv:
        system_info()
        return 0
    engine, server = build_server(argv)
    host, port = server.server_address[:2]
    SRV_INF("main", "listening on http://%s:%d", host, port)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        stop.wait()
    finally:
        SRV_INF("main", "shutting down")
        server.shutdown()
        server.server_close()
        engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
