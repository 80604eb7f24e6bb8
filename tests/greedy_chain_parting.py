"""Where greedy decode with chains of K = 1 and K = 16 parts, in the port's
engine and in the JAX package's, on the same synthetic model (the GPU
tests' two-layer llama fixture, tests/test_torch_gpu.py `_tiny_gguf`),
bf16 weights and a bf16 KV cache, both on the CPU: four prompts of 40,
23, 9 and 17 tokens, 300 greedy tokens each (ignore_eos), -np 4 -c 2048.

    JAX_PLATFORMS=cpu python -m tests.greedy_chain_parting [out.json]

Prints, for each package, the first token at which the K = 1 and K = 16
texts of each prompt differ (None: equal), and where the port's texts
part from the JAX package's. Not a test: it records a property of the
reference (its K = 1 and K = 16 chains part under bf16 on the CPU)."""

import json
import sys
import tempfile

import numpy as np

N_TOKENS, N_CTX, SLOTS = 300, 2048, 4


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(300, 500, k).tolist() for k in (40, 23, 9, 17)]


def _collect(tasks):
    out = []
    for t in tasks:
        while True:
            kind, payload = t.result_q.get(timeout=3000)
            if kind == "final":
                out.append(list(payload.generated))
                break
            if kind == "error":
                raise payload
    return out


def port_texts(path, chain):
    import torch
    from llama_box_tpu_torch.gguf import GGUFFile
    from llama_box_tpu_torch.models.loader import load_model
    from llama_box_tpu_torch.sampling import SamplerParams
    from llama_box_tpu_torch.server.engine import Engine, EngineConfig
    from llama_box_tpu_torch.server.task import CompletionsTask
    from llama_box_tpu_torch.tokenizer import Tokenizer
    cfg, params = load_model(path, dtype=torch.bfloat16, device="cpu")
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    eng = Engine(cfg, params, tok, EngineConfig(
        n_slots=SLOTS, n_ctx=N_CTX, n_ubatch=32, kv_dtype="bfloat16",
        decode_chain=chain), device="cpu")
    eng.start()
    try:
        ts = [CompletionsTask(list(p), SamplerParams(temp=0.0,
                                                     ignore_eos=True),
                              tokenizer=tok, max_tokens=N_TOKENS)
              for p in _prompts()]
        for t in ts:
            eng.submit(t)
        return _collect(ts)
    finally:
        eng.stop()


def jax_texts(path, chain):
    import jax.numpy as jnp
    from llama_box_tpu.gguf import GGUFFile
    from llama_box_tpu.models import load_model
    from llama_box_tpu.sampling import SamplerParams
    from llama_box_tpu.server import Engine, EngineConfig
    from llama_box_tpu.server.task import CompletionsTask
    from llama_box_tpu.tokenizer import Tokenizer
    cfg, params = load_model(path, dtype=jnp.bfloat16)
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    eng = Engine(cfg, params, tok, EngineConfig(
        n_slots=SLOTS, n_ctx=N_CTX, n_ubatch=32, kv_dtype="bfloat16",
        decode_chain=chain))
    eng.start()
    try:
        ts = [CompletionsTask(list(p), SamplerParams(temp=0.0,
                                                     ignore_eos=True),
                              tokenizer=tok, max_tokens=N_TOKENS)
              for p in _prompts()]
        for t in ts:
            eng.submit(t)
        return _collect(ts)
    finally:
        eng.stop()


def first_part(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def main(argv) -> int:
    from tests.test_torch_gpu import _tiny_gguf
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/tiny-f16.gguf"
        _tiny_gguf(path, "f16")
        texts = {(pkg, k): fn(path, k)
                 for pkg, fn in (("port", port_texts), ("jax", jax_texts))
                 for k in (1, 16)}
    res = {
        f"{pkg} K1 vs K16": [first_part(a, b) for a, b in zip(
            texts[pkg, 1], texts[pkg, 16])] for pkg in ("port", "jax")}
    for k in (1, 16):
        res[f"port vs jax K{k}"] = [first_part(a, b) for a, b in zip(
            texts["port", k], texts["jax", k])]
    for key, v in res.items():
        print(f"{key}: {v}")
    if len(argv) > 1:
        with open(argv[1], "w") as f:
            json.dump({"parts": res, "texts": {f"{p} K{k}": t for (p, k), t
                                               in texts.items()}}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
