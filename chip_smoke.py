#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llama_box_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failure raises and exits non-zero; nothing falls back):
 1. device: the card's name and power limit (nvidia-smi) and torch's name;
 2. build: nvcc builds every kernel from llama_box_tpu_torch/csrc into
    build/torch_kernels/ and `-Xptxas -v` is printed;
 3. kernel vs plain: each kernel against its plain torch version on the
    card, at the shapes the server below gives it (bf16 and int8 caches;
    the w8a8 projections of a 4 x 512 prefill, of one 500-token prompt and
    of 4 decode rows, f32 and bf16 out) plus
    variants at smaller shapes; cache positions a kernel must never read,
    output guards a kernel must never write and the fused tail's scratch
    hold NaN. w8a8_matmul must equal its plain version bit for bit, and
    so must the fused tail's xnew rows (its first phase has no norm); a
    cold 500-token prefill must equal, bit for bit, the same prompts with
    their first 137 / 64 / 1 / 300 positions in a bf16 cache, and a decode
    query with nv = 16 chain rows must equal, bit for bit, the same query
    with nv = 1 (its other keys in the cache; bf16 and int8 caches).
    Then the attention variants at their families' published heads
    (ATTN_KERNEL_CASES): Gemma-3-1B's 4 / 1 heads of 256 at C 4096 under
    a local layer's 512 window and a global layer's none (prefill at pos0
    0 and 1024, decode at cpos 1023 and 3000), gemma-2-2b's 8 / 4 heads
    of 256 under its softcap 50, BLOOM-560m's 16 heads of 64 under ALiBi,
    phi-2's 32 heads of 80 and phi-3-mini's 32 of 96; f32 and int8-cache
    variants at D 80, 96, 256 with a window and ALiBi; and both bit checks
    again at D 256 under the 512 window. Then multi-head latent attention
    (MLA_KERNEL_CASES): K / V widths 192 / 128 at DeepSeek-V2-Lite's 16
    heads and 96 / 64 at MiniCPM3-4B's 40, one query head a cache head, C
    4096, bf16 and int8 caches (prefill q[4,H,1,512,D] at pos0 0 and 1024,
    decode R 16 at cpos 1023 and 3000), f32 and windowed int8 variants, and
    both bit checks at each pair;
 4. times: kernel, plain version and a library yardstick (SDPA for the
    attention kernels; for w8a8_matmul torch._int_mm on the codes with
    the weight K-major, beside it _int_mm on the weight as stored and
    torch.matmul in bf16 on the dequantized weight; never used by the
    port; under a window or ALiBi SDPA gets the same float mask) with
    CUDA events on a cold L2 (medians of 15 launches, of PLAIN_REPS for a
    plain version), beside the bound max(bytes / 3.35 TB/s, ops
    / peak), the peak being 989 TFLOP/s bf16 or 1979 TOP/s int8, the
    bytes and operations those of the keys each call's window leaves (K
    read at D, V at Dv; 2 x keys x (D + Dv) operations a query row); at
    unequal widths also the SDPA backend that took the call (the first of
    flash, memory-efficient, cuDNN, math); phase 4w also times w8a8_matmul's row-quantize pass alone
    (bound: M*K*3 + 4*M bytes), the fused kernels at Llama-3-8B's widths
    (kernel only, not served) and counts the kernels each w8a8 call runs
    (torch.profiler);
 3n/4n. the row-norm kernel (csrc/norm.cu: RMSNorm and LayerNorm, with
    an optional bias and per-head weights) against its plain version at
    the rows the served models give it (4 decode rows and a 4 x 512
    prefill of TinyLlama, Qwen3's per-head q norm, Pythia's biased
    LayerNorm) and variants (chameleon's per-head weights, an odd width,
    f32 rows of an FF width), within one bf16 rounding; a row's bits the
    same alone, among 4 rows and among 36 (a verify pass); then its
    times beside the bound (bytes), the plain version and torch's
    rms_norm / layer_norm (never used by the port);
 3m/4m. the routed-expert kernel (csrc/moe_ffn.cu, port-only) against
    its plain version at the rows phase 13 gives it (Qwen3-30B-A3B's
    layer, 128 experts, 8 a token, 2048 x 768: a decode step of 4 rows, a
    verify pass of 36, a 4 x 512 prefill of 2048) and at gpt-oss-20b's
    widths (32 experts, 4 a token, 2880 x 2880, swiglu_oai, biases, an
    expert no row picks), within MOE_RTOL x max|plain|, NaN output guards
    intact; a row's bits the same alone, among 36 and among 2048; then
    its times beside the bound (the distinct experts' bytes, or 6 N K E F
    operations), the plain version and torch._grouped_mm's three
    products on the rows sorted by expert (never used by the port);
 3r/4r. the recurrent kernels (port-only: the JAX scans are XLA):
    csrc/ssm_scan.cu against its plain version at the rows phase 17 gives
    it (Mamba-1.4B's mixer, 4096 channels of 16 states, and, behind
    --families, granite-4.0-h-micro's, 64 heads of 64 with 128 states: a
    4 x 512 prefill and 4 decode rows) and at Jamba2-3B's 5120 channels;
    csrc/wkv.cu's three rules at RWKV-7's and RWKV-6's 32 heads of 64 and
    qwen3-next's delta rule (32 v-heads over 16 k-heads of 128), prefill
    and decode rows. Slots of seq_lens T, a part, 0 (its state NaN: it
    must keep its bits) and 1, within REC_REL x max|plain|; a prefill of
    P + 1 + the rest rows bit-equal, outputs and state, to the whole (so
    a one-row step equals the row after a P-row prefill). Then their times
    beside the bound (inputs, outputs, the state read and written once,
    over 3.35 TB/s, or the f32 operations over 67 TFLOP/s) and the plain
    version's; no PyTorch call computes either function;
 5. end to end, bf16 path: a synthetic TinyLlama-1.1B-width GGUF (4 of
    its 22 layers; random F16 weights from --seed, a 32000-piece SPM
    vocab, a chatml template;
    it and 5w's and 5q's files are written by three worker processes
    while phases 3 and 4 run, all three done before phase 5 starts)
    is served by the port's own HTTP server at -np 4 -c 8192 -ub 512
    --decode-chain 16, CUDA graphs on and chains pipelined (the
    defaults: up to two further chains go out before the host waits for
    the oldest, the first off the prefill's first tokens). The launch
    counts are set to 0 just before the requests and read just after (a
    graph replay adds its kernels' launches); both attention kernels must
    have run and the server must have captured graphs.
    Then, in process: the card's f32 logits against an f32 CPU reference
    on a small input, and greedy K=1 and K=16 decode chains identical for
    the bf16 and the int8 cache;
 5w. end to end, w8a8 path: the same model written with Q8_0 weights,
    served with --weights-dtype quantized and the same flags and traffic;
    all five kernels must have run. In process: the card's logits against
    the plain versions on the CPU over the same QTensors (cosine >= 0.99),
    greedy K=1 and K=16 identical for both caches, and the fused kernels'
    decode logits against LLAMA_BOX_TPU_NO_FUSED (cosine >= 0.99);
 3q/4q. the grouped kernels (q4_matmul, q8_matmul) against their plain
    versions at the shapes 5q gives them (4 x 512 prefill rows and 4
    decode rows: wqkv, wo, gate|up, down, output) and at variants (packed
    and int8 codes, bf16 and f32 scales, mins and none, groups 16 and 32,
    1 to 200 rows, 4160 = 65 x 64 columns), NaN output guards, and the
    bf16 output bit-equal to the f32 one rounded; then times of both
    outputs beside the bound, the plain version and torch.matmul in bf16
    on the dequantized weight, at those shapes and at Llama-3-8B's widths
    (kernel only, not served);
 5q. end to end, grouped path: the same floats written with Q4_K_M's
    tensor types (Q6_K output and ffn_down, Q4_K elsewhere), served with
    LLAMA_BOX_TPU_PACKED4=1 --weights-dtype quantized and the same flags
    and traffic; q4_matmul, q8_matmul and the attention kernels must have
    run, the w8a8 kernels not. In process: the card's logits against the
    CPU path (q_matmul_ref) over the same QTensors (cosine >= 0.99) and
    greedy K=1 and K=16 identical for both caches;
 5c/5wc/5qc. after each path, in process: three fresh engines of the
    model, with CUDA graphs (the default: each decode chain and prefill
    pass replays one captured graph) and pipelined chains (the default),
    with EngineConfig(cuda_graphs=False, pipeline_chain=False), and with
    graphs but pipeline_chain=False, each behind the same HTTP routes;
    after two warm-up waves of other prompts, five measured waves (the
    main path's prompts, then new ones of the same lengths), the modes in
    turn: greedy texts and the seeded text identical in all three modes
    in every wave and to the main path's in the first, and speculated
    chains counted in the default mode (above 0) and in the others (0);
    the medians of TTFT p50, prefill, decode and window tok/s (every
    generated token over the waves' wall), graph count and pool memory of
    each; then requests that arrive while three others decode (their
    client ms to the first token, texts identical in all modes);
    `--profile` profiles each mode; the
    host's microseconds per kernel-entry C call, per torch op, per eager
    decode step and per replay of a 16-step chain;
 6. the in-place KV-cache edits, on the bf16 path's model (its weights
    as served), once with a bf16 and once with an int8 cache: context
    shift at -np 4 -c 2048 (slot capacity 512): 4 concurrent greedy
    requests of 200 to 350 prompt tokens and 700 tokens each, every one
    ending with "length" at 700 after at least 2 shifts of 128 rows, the
    slots shifting at different steps; the same texts and shift steps
    with graphs and chains pipelined (every graph captured first, the
    wave under set_sync_debug_mode("error")), graphs in lockstep, eager
    in lockstep and --decode-chain 1; no cache leaf's data_ptr moves;
    one shift against a float64 host reference of it (bf16 within one
    ulp, or of the f32 rounding where the rotation cancels; int8 codes
    within 1, scales equal) and the next step's logits off the shifted
    cache against an f32 CPU forward (reference_check's gates); the
    device ms of one shift beside its bytes bound. Then the
    cross-slot prefix copy at -np 4 -c 8192: while a chat with a
    1500-token shared prefix decodes, 2 + 5 chats with that prefix (three
    one-token chats of other prompts first take the idle slots), each
    with cached_tokens >= 1499 by one copy (the copied rows bit-equal to
    the donor's), against --prompt-cache-share-min -1: greedy texts
    equal up to the first near tie, TTFT p50 of the 5 both ways, the
    device ms of one 1500-row copy beside its bytes bound;
 7/7w/7q. host-controlled decode on each path's model (its weights and
    settings as served, prefix cache on), fresh engines with CUDA graphs
    (every key warmed first) and fresh eager ones behind the same
    routes: four concurrent requests
    (a greedy JSON-schema chat, a greedy GBNF completion, a seeded
    mirostat chat, a greedy DRY chat with tools and a grammar forcing one
    tool call), the kernel counts from 0 (the path's kernels must run);
    the JSON parses with the schema's keys, the GBNF text is in its
    language, the tool chat ends with one tool call; a plain greedy chat
    beside a mirostat one (one-token passes) gives its text alone
    (chained, on an engine of its own: both prefill the prompt cold);
    texts identical with graphs and eager; no graph captured
    in the measured requests; one request at X-Request-Tokens-Per-Second
    20 runs within 10 % of it past its burst; /tokenize round-trips
    through /detokenize, /metrics parses and its counters grow,
    /lora-adapters is empty. Printed: each wave pass's device ms (CUDA
    events around its replay) and host ms (its wall less that), whether
    the plain chat repeated from the prefix cache gave the same text
    (recorded, not checked), the host sampler's ms a token (grammar and
    mirostat),
    the tok/s of each constrained request, of the plain one beside and
    alone, and of the rate-limited one;
 8/8w/8q. speculative decoding. 8w and 8q, after each path's phase 7:
    four greedy ignore_eos chats (about 160 prompt tokens, 128 tokens)
    by plain chained decode and by the path's model drafting for itself
    (--draft-p-min 0, --draft-max 8, four rounds a pass; graphs, every
    key captured first), the kernel counts from 0 over the latter (the
    path's kernels must run); 8, after phase 6, on the bf16 path's model:
    the same chats by plain decode (K 16 and K 1), by the CLI's own
    servers with --lookup-ngram-min 2 --draft-max 8 --decode-chain 1 and
    with -md a 2-layer draft (the same file's first two layers, written
    from the same seed) --draft-p-min 0, each counting its kernels from 0
    (flash prefill and flash decode must run), /metrics' drafted counter
    equal to the usage's, support_speculative true; then, in process, the
    n-gram, self-draft and 2-layer draft engines with graphs pipelined
    (self-draft), graphs in lockstep and eager (SPEC_EAGER_TOKENS a
    chat). Every speculative text
    must equal plain chained decode's up to the first near tie (a top-2
    log-prob margin within NEAR_TIE in either run); no graph may be
    captured in a measured wave; the self-draft must accept at least
    SELF_ACCEPT_MIN of its drafts. Printed: decode and window tok/s,
    TTFT, drafted and accepted tokens, speculated passes and the graph
    pool of each; the device ms of one verify pass of 9 rows a slot, of
    one one-row pass and of a 16-step chain (CUDA events around a
    replay) and the flash decode launches of a verify pass; a
    self-drafting run past the capacity (-c 2048, 700 tokens, shifts
    that move the draft cache too) against plain chained decode; and,
    on every path, whether a verify forward's logits and cache rows are
    bit-equal to those of its rows' one-row decode steps (bf16 and int8
    caches);
 10/10w/10q. embeddings and rerank. 10w and 10q, after each path's main
    path: one /v1/embeddings request of 9 inputs (a pass of 8 rows of
    more than 64 token rows, then one of 1 row: on w8a8 the fused
    kernels), the kernel counts from 0 around it (the path's projection
    kernels and flash prefill must run, flash decode not). 10, after
    phase 8: a synthetic BERT GGUF at BAAI/bge-base-en-v1.5's widths (12
    x 768, 12 heads, FF 3072, 512 positions, a 30522-piece WordPiece
    vocab, pooling cls, random floats from --seed) served by the CLI with
    --embeddings: one request of 64 texts of 16 to 500 tokens, float then
    base64 (equal), every vector against the f32 CPU encoder (cosine >=
    BERT_COS); a cross-encoder of the same widths (cls and cls.output
    heads, pooling rank) with --rerank: a query with 32 documents,
    normalized and not, the raw scores within RERANK_ATOL of the f32 CPU
    encoder's and the top 5 in its order but for near ties; each request
    sent twice first, no graph captured in the measured ones. Then the
    bf16 path's model: three greedy chats at -np 4 alone and with a
    32-input /v1/embeddings request sent once all three decode (fresh
    engines, graphs, pipelined): the same texts, every vector against the
    f32 CPU forward_embeddings (cosine >= LLAMA_COS), flash prefill
    launched in the request. On both models, one ("embed", 8, 512)
    replay bit-equal to the eager pass and its device ms beside its
    bound; printed: embeddings tok/s, rerank docs/s;
 11. the dense llama variants at published widths, after phase 10: two
    synthetic GGUFs (Q8_0 matrices, F32 vectors, random from --seed, a
    synthetic vocabulary of the published size, chatml; depth cut to 4
    layers since phase 15, 8 before; each written with its f32 forward on
    the host by a worker from phase 6 on, as are phase 12's, 13's and
    14's): Qwen3-1.7B's (Qwen/Qwen3-1.7B config.json: 28 x 2048, 16 / 8
    heads of 128, FF 6144, vocab 151936, tied embeddings, per-head q/k RMS
    norms) and Pythia-1.4B's (EleutherAI/pythia-1.4b config.json: 24 x
    2048, 16 heads of 128, rotary 32 of them, parallel residual, LayerNorm
    with biases, fused biased qkv, ungated GELU FFN with biases, untied
    output). Each is
    served by the CLI on the bf16 path (the file dequantized to bf16) and
    on the w8a8 path (--weights-dtype quantized): two warm-up waves, then 4
    greedy chats of about 200 prompt tokens and 64 tokens with graphs
    and chains pipelined, the same on a fresh eager engine (texts equal),
    one more request counting its kernels from 0 (the row-norm kernel,
    flash prefill and decode must run, and on w8a8 w8a8_matmul, for
    Qwen3 the fused kernels too; no other), small_forward's logits
    against the f32 CPU forward of the same file (cosine >= VARIANT_COS),
    and one captured decode step: its kernels a layer with the row-norm
    kernel and with the norms' plain torch versions, its row-norm
    launches, and no torch mean reduction (a norm's) in it;
 12. the attention variants at published widths, after phase 11, on
    phase 11's machinery (depth cut to 6 and 4 layers for the script's
    time limit): Gemma-3-1B's (google/gemma-3-1b-pt
    config.json: 26 x 1152, 4 / 1 heads of 256, FF 6912, vocab 262144,
    a 512 window on 5 layers of 6, rope bases 1e6 and 1e4, q/k norms, post
    norms, tied embeddings) and BLOOM-560m's (bigscience/bloom-560m: 24 x
    1024, 16 heads of 64, FF 4096, vocab 250880, ALiBi, embedding
    LayerNorm, biases, tied embeddings), each on the bf16 and w8a8 paths
    at -np 4 -c 4096 with prompts of about 700 tokens (past the window);
    the cosine is long_forward's (640 positions, the second chunk reading
    the first from the cache, then a decode step) to the f32 CPU forward;
 13. a mixture-of-experts model at published widths, after phase 12, on
    phase 11's machinery: Qwen3-30B-A3B's (Qwen/Qwen3-30B-A3B
    config.json: 48 x 2048, 32 / 4 heads of 128, per-head q/k norms, 128
    experts, 8 a token, expert FF 768, norm_topk_prob, rope base 1e6,
    vocab 151936, untied output; Q8_0 matrices and expert stacks, the
    router F32; depth cut to 4 layers; the file, about 3 GB), on the bf16 and w8a8 paths (the
    experts bf16 on both): the routed-expert kernel must run; the cosine
    to the f32 CPU forward of the file (the plain versions on the host);
    then verify rows bit-equal to one-row steps (bf16 and int8 caches)
    and, on bf16, a self-drafting wave counting its kernels;
 14. multi-head latent attention at published widths, after phase 13, on
    phase 11's machinery: DeepSeek-V2-Lite's (deepseek-ai/DeepSeek-V2-Lite
    config.json: 2048 wide, 16 heads, no q rank (a plain wq), kv rank 512,
    K 128 + 64 rope / V 128, the first layer dense with FF 10944, then 64
    experts, 6 a token, expert FF 1408, 2 shared experts, YaRN factor 40
    over 4096, vocab 102400, untied; 4 of 27 layers: two layer groups, so
    a token a pass) and MiniCPM3-4B's (openbmb/MiniCPM3-4B: 2560 wide, 40
    heads, q rank 768, kv rank 256, K 64 + 32 / V 64, FF 6400, vocab
    73448, its embedding, residual and logit scales, longrope factors from
    the seed; 4 of 62 layers, uniform: chains, graphs, pipelining), Q8_0
    matrices, each on the bf16 and w8a8 paths as phase 13's: both attention kernels (and on
    DeepSeek the expert kernel) must run; the cosine to the f32 forward of
    the file on the host (the plain versions); verify rows bit-equal to
    one-row steps (bf16 and int8 caches); on MiniCPM3 greedy K = 1 equal
    to K = 16;
 15. image and audio chats with --mmproj at published widths, after phase
    14: three synthetic GGUF + mmproj pairs written by workers beside
    phases 3 and 4 (Q8_0 language models cut to 4 layers; F16 towers):
    llava-1.5-7b (Llama-2-7B widths; CLIP ViT-L/14-336, 23 blocks, 576
    image tokens, the mlp projector), on the bf16 and w8a8 paths;
    Qwen2-VL-2B (Qwen2-1.5B widths with M-RoPE [16, 24, 24]; its ViT, 8 of
    32 blocks, at two images' native grids); Qwen2-Audio-7B (Qwen-7B
    widths; whisper-large-v3's encoder, 8 of 32 blocks, and the qwen2a
    head; a 3 s WAV). Each served by the CLI with --mmproj at -np 4: on
    bf16 each medium's projected rows on the card against the f32 host
    tower (cosine >= MM_EMB_COS) and the tower's device ms; two warm-up
    waves, then a measured wave of 4 greedy chats (a text-only chat beside
    media chats; its captures, graphs and pool printed), the first media
    chat again (the same text, its rows from the prefix cache), one media
    request counting its kernels from 0 (flash prefill and decode must
    run; on w8a8 w8a8_matmul) whose served first answer token's logits
    (read from the engine's prefill program) are held against the f32
    host forward of the chunks the server built (cosine >= MM_LOGIT_COS)
    and, on Qwen2-VL, its decode steps' top log-prob gaps against the
    host forward at position + mrope_delta (MM_DECODE_GAP), on llava
    greedy K = 1 equal to K = 16. Phase 12 adds,
    on Gemma-3-1B's bf16 path, an image chat through an mlp mmproj (its
    image rows under the bidirectional span) and the spanned logits
    through the kernel against its plain version;
 16. LoRA adapters and a control vector, after phase 10, on phase 5's
    TinyLlama-width files (4 layers, -np 4 -c 8192 -ub 512
    --decode-chain 16): two adapters written from the seed (a: rank 16,
    alpha 32, all seven projections of every layer and output.weight; b:
    rank 8, alpha 16, q, v and down) and a control vector (every layer).
    16a / 16w / 16q: --lora a --lora b --lora-per-request (the prefix
    cache off, see lora_serve) on the bf16, w8a8 and q4 paths: a wave of
    4 greedy chats, one adapter mix a slot (LORA_MIXES), whose texts
    equal each request served alone, the wave at K = 1 and with n-gram
    drafts; its captures against the same wave without `lora` fields and
    against the base weights' engine after the same waves; decode tok/s,
    TTFT p50 and kernels a layer a decode step against the base; one
    request's kernels (the w8a8 tail never: the scale rows shut the fused
    gates). 16b: --lora a merged on bf16, the served first answer token's
    logits against the f32 host forward of the merged weights, and the
    dynamic path at a's scale against the host merge of a's layer pairs
    (cosine >= LORA_COS). 16c: --control-vector-scaled c 0.8
    --control-vector-layer-range 2 3 on bf16 and w8a8 against the f32
    host forward with the vector (CVEC_COS), on w8a8 also against the
    plain versions on the host over the same QTensors (CVEC_PLAIN_COS),
    the fused w8a8 kernels still launched;
 17. the recurrent families at published widths, after phase 15, on
    phase 11's machinery: three synthetic GGUFs (Q8_0 matrices, F32
    vectors and mixer smalls, random from --seed, a synthetic vocabulary of
    the published size, chatml; tests/fixtures/make_tiny_mamba.py's and
    make_tiny_rwkv.py's tensor conventions, written by workers beside
    phases 3 and 4, each with its f32 forward on the host):
    Mamba-1.4B's (state-spaces/mamba-1.4b-hf config.json: 48 x 2048,
    d_inner 4096, d_state 16, dt_rank 128, conv 4, vocab 50280, tied; 8
    layers; a pure stack: chains of 16 in graphs) on the bf16 and w8a8
    paths and RWKV-7-1.5B's (fla-hub/rwkv7-1.5B-world: 24 x 2048, head
    64, FF 8192, LoRA ranks 96 / 96 / 64 / 256, vocab 65536; 4 layers) on
    bf16 (layer groups: a token a pass); the hybrid granite-4.0-h-micro
    is served behind --families, for the script's time limit. Each served
    by the CLI at -np 4 -c 4096: two warm-up waves, 4 greedy chats of
    about 200 + 64 tokens with graphs and chains pipelined, the same on a
    fresh eager engine (texts equal), one request counting its kernels
    from 0 (row_norm and ssm_scan on Mamba, wkv on RWKV-7, w8a8_matmul on
    w8a8; no other), rec_small_forward's logits against the host's
    (cosine >= VARIANT_COS), one captured decode step's kernels; a
    second turn extending the first exactly (its 37 tokens fill the ramped
    chains, so the state stays clean) must reuse the state and give a cold
    engine's tokens up to the first near tie; TTFT p50 of 4 requests;
 9. print a `kernels` line (eleven kernels; launches count graph replays;
    each also with its launches in the self-drafting waves of 8/8w/8q,
    in phase 8's n-gram, self-draft and 2-layer draft waves and in each
    path's embeddings request of phase 10, where bf16's window also holds
    the chats' chains, and in one request of each phase 11, 12, 13, 14
    and 15 model and path; the attention kernels also with their variant and MLA
    shapes' times, moe_ffn with all its timed shapes, its launches those
    of one phase 13 bf16 request; ssm_scan and wkv with their timed
    shapes, their launches those of one phase 17 request on Mamba-1.4B's
    and RWKV-7's bf16 paths), an `e2e` line (three paths and phases
    6, 7, 8, 10, 11, 12, 13 and 14), the card line, and as the last line
    {"ok": true, "device": {...}}.

Flags outside the default run: --families serves jetmoe/jetmoe-8b's
widths (2 of 24 layers: mixture of attention and MoE FFNs) and
apple/OpenELM-270M's (all 16 layers, per-layer heads and FFN widths) on
the bf16 path on phase 11's machinery (cosine to the f32 host forward),
and the recurrent ibm-granite/granite-4.0-h-micro's widths (40 x 2048,
mamba2 64 heads of 64, d_state 128, 1 group, 32 / 8 heads of 64 at
layers 5, 15, 25, 35, FF 8192, vocab 100352, multipliers 12 / 0.22 / 8,
tied; its first 6 layers: attention at 5; ssm_scan, row_norm and both
flash kernels must run), RWKV/v6-Finch-1B6's (4 of 24 layers) and
Qwen3-Next-80B-A3B's (its first 4 layers: three gated DeltaNet layers,
one gated attention layer of 16 / 2 heads of 256, 512 experts, 10 a
token) on phase 17's, while AI21-Jamba2-3B's (its first 8 layers) must be
refused at load: its 20 query heads over one KV head exceed flash decode's
group of 16;
--depth-check N holds Qwen3-1.7B's w8a8 path at N layers against the
plain versions and f32, layer by layer (depth_check).

It imports nothing of JAX and nothing of the JAX package. Without CUDA,
or without the llama_box_tpu_torch package beside it, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

# TinyLlama-1.1B (BASELINE config 1): published widths; depth cut from 22
# to 12 layers for the script's time limit with phase 13 beside it, to 8
# with phase 15 beside it, and to 4 with phase 17 beside it
L, E, H, HKV, D, FF, V = 4, 2048, 32, 4, 64, 5632, 32000
N_SLOTS, N_CTX, N_UBATCH, CHAIN = 4, 8192, 512, 16
SLOT_CTX = N_CTX // N_SLOTS
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12          # H100 SXM data sheet peaks
INT8_OPS = 1979e12
BF16_ATOL, F32_ATOL = 2e-2, 1e-4
# fused kernels against their plain versions (the JAX tests' tolerances):
# the rms norm's sum of squares runs in another order, so one bf16
# rounding and then one int8 code can move
NORM_QMM_TOL, TAIL_TOL = 1e-2, 2e-2
# grouped kernels against their plain versions, x max|out|: f32 sums of
# the same exact bf16 products in another order (about sqrt(in) x 2**-23);
# a weight moved by one bf16 rounding would give about 1.4e-3
Q_REL = 1e-4
# Llama-3-8B's widths (kernel rows only)
E8, FF8, V8 = 4096, 14336, 128256
CHATML = ("{% for message in messages %}{{'<|im_start|>' + message['role'] "
          "+ '\n' + message['content'] + '<|im_end|>' + '\n'}}{% endfor %}"
          "{% if add_generation_prompt %}{{'<|im_start|>assistant\n'}}"
          "{% endif %}")


_T0 = time.perf_counter()


def log(*a):
    """Print a line; a phase's heading (== ...) ends with the seconds since
    the script started."""
    if a and isinstance(a[0], str) and a[0].startswith("=="):
        a = (f"{a[0]}  [{time.perf_counter() - _T0:.1f} s]", *a[1:])
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing


# launches a plain version's median is taken over (a kernel's: 15); the
# plain versions run tens to hundreds of torch ops a call
PLAIN_REPS = 5


def device_ms(fn, flush: torch.Tensor, n: int = 15) -> float:
    """Median device time of fn() in ms: each launch after L2 is evicted
    (a 128 MB write), bracketed by CUDA events. A spin kernel first lets
    the host queue all n launches ahead, so host overhead between the
    events is not timed."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    pairs = []
    torch.cuda._sleep(int(min(2e9 * host_s * n * 1.5 + 2e6, 4e8)))
    for _ in range(n):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: float, flops: float,
             peak: float = BF16_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def ptxas_entries(report: str, names):
    """(entry, 'Used ... registers ... smem ...', '... spill ...') of each
    entry in an `nvcc -Xptxas -v` report whose name contains one of
    `names`."""
    out, entry, spill = [], None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
            spill = ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            if any(n in entry for n in names):
                out.append((entry, line.split("info    :")[-1].strip(),
                            spill))
            entry = None
    return out


# ---------------------------------------------------------------------------
# kernel cases


def _nan_fill(x: torch.Tensor, starts, axis_pos: int) -> None:
    """x[..., b, p:, ...] = NaN for slot b from starts[b] on (axis_pos is
    the position axis; the slot axis precedes it)."""
    for b, p0 in enumerate(starts):
        idx = [slice(None)] * x.ndim
        idx[axis_pos - 1], idx[axis_pos] = b, slice(int(p0), None)
        x[tuple(idx)] = float("nan")


def make_cache(g, B, C, dtype, quant, dev, hkv=HKV, d=D, dv=None):
    """K cache [B, C, Hkv, D] and V cache [B, C, Hkv, Dv] (Dv = D unless
    given) in dtype, or int8 codes + bf16 scales."""
    k = torch.randn(B, C, hkv, d, generator=g, device=dev)
    v = torch.randn(B, C, hkv, dv or d, generator=g, device=dev)
    if not quant:
        return k.to(dtype), v.to(dtype), None, None
    ks = (torch.rand(B, C, hkv, generator=g, device=dev) * 0.04 + 0.01)
    vs = (torch.rand(B, C, hkv, generator=g, device=dev) * 0.04 + 0.01)
    kq = (k / ks[..., None]).round().clamp(-127, 127).to(torch.int8)
    vq = (v / vs[..., None]).round().clamp(-127, 127).to(torch.int8)
    return kq, vq, ks.to(torch.bfloat16), vs.to(torch.bfloat16)


def alibi_slopes(n_heads, hkv, dev, max_bias=8.0):
    """[Hkv, G] ALiBi slopes of n_heads heads (the model's formula,
    models/llama.alibi_values)."""
    from llama_box_tpu_torch.models.llama import alibi_values
    return torch.tensor(alibi_values(n_heads, max_bias), dtype=torch.float32,
                        device=dev).view(hkv, -1)


def prefill_case(g, dev, *, B=4, G=8, T=512, C=SLOT_CTX, pos0=(0,) * 4,
                 n_valid=None, quant=False, dtype=torch.bfloat16,
                 win=(0, 0), spans=None, sinks=False, softcap=0.0,
                 hkv=HKV, d=D, alibi=False, dv=None):
    n_valid = n_valid or (T,) * B
    dv = dv or d
    q = torch.randn(B, hkv, G, T, d, generator=g, device=dev).to(dtype)
    kc, vc, ks, vs = make_cache(g, B, C, dtype, quant, dev, hkv, d, dv)
    _nan_fill(ks if quant else kc, pos0, 1)      # never read: >= pos0
    _nan_fill(vs if quant else vc, pos0, 1)
    kr = torch.randn(B, T, hkv, d, generator=g, device=dev).to(dtype)
    vr = torch.randn(B, T, hkv, dv, generator=g, device=dev).to(dtype)
    meta = torch.zeros(B, 4, dtype=torch.int32)
    meta[:, 0] = torch.tensor(pos0)
    meta[:, 1] = torch.tensor(n_valid)
    if spans is not None:
        meta[:, 2:] = torch.tensor(spans)
    args = (q, kc, vc, kr, vr, meta.to(dev),
            torch.tensor(win, dtype=torch.int32, device=dev))
    kw = dict(k_scale=ks, v_scale=vs, softcap=softcap,
              sinks=(torch.randn(hkv, G, generator=g, device=dev)
                     if sinks else None),
              alibi=alibi_slopes(hkv * G, hkv, dev) if alibi else None)
    return args, kw


def decode_case(g, dev, *, B=4, G=8, C=SLOT_CTX, R=CHAIN, cpos=(1023,) * 4,
                nv=(CHAIN,) * 4, quant=False, dtype=torch.bfloat16,
                win=(0, 0), sinks=False, softcap=0.0, hkv=HKV, d=D,
                alibi=False, dv=None):
    dv = dv or d
    q = torch.randn(B, hkv, G, d, generator=g, device=dev).to(dtype)
    kc, vc, ks, vs = make_cache(g, B, C, dtype, quant, dev, hkv, d, dv)
    cstart = [c - n + 1 for c, n in zip(cpos, nv)]
    _nan_fill(ks if quant else kc, cstart, 1)    # never read: >= chain start
    _nan_fill(vs if quant else vc, cstart, 1)
    kr = torch.randn(B, R, hkv, d, generator=g, device=dev).to(dtype)
    vr = torch.randn(B, R, hkv, dv, generator=g, device=dev).to(dtype)
    meta = torch.tensor(list(zip(cpos, nv)), dtype=torch.int32, device=dev)
    args = (q, kc, vc, kr, vr, meta,
            torch.tensor(win, dtype=torch.int32, device=dev))
    kw = dict(k_scale=ks, v_scale=vs, softcap=softcap,
              sinks=(torch.randn(hkv, G, generator=g, device=dev)
                     if sinks else None),
              alibi=alibi_slopes(hkv * G, hkv, dev) if alibi else None)
    return args, kw


def check(name, kernel, plain, args, kw, atol, valid=None) -> float:
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    if valid is not None:          # prefill: only rows < n_valid are defined
        got = torch.cat([got[b, ..., :n, :] for b, n in enumerate(valid)],
                        dim=-2)
        want = torch.cat([want[b, ..., :n, :] for b, n in enumerate(valid)],
                         dim=-2)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output (a masked, NaN "
                             "position was read)")
    err = float((got - want).abs().max())
    log(f"  {name:<44s} max_abs_err {err:.3e}  (tol {atol:g})")
    if not err <= atol:
        raise AssertionError(f"{name}: max_abs_err {err} > {atol}")
    return err


# ---------------------------------------------------------------------------
# bytes and operations of one call (what these inputs need)


def _elem(t):
    return 0 if t is None else t.element_size()


def prefill_work(args, kw):
    """Bytes and operations of one prefill call on these inputs: the cache
    positions some row of a slot sees (window floor to pos0) read once (K
    at D, V at Dv, an int8 cache's two scales), and each row's visible
    keys (causal, under the window) scored at D and weighted at Dv: 2 x
    keys x (D + Dv) operations a query row."""
    q, kc, vc, kr, vr, meta, win = args
    B, Hkv, G, T, Dq = q.shape
    Dv = vc.shape[-1]
    w = int(win[0])
    pos0 = meta[:, 0].tolist()
    nval = meta[:, 1].tolist()
    nbytes = q.numel() * q.element_size() + (kr.numel() + vr.numel()) \
        * kr.element_size() + B * Hkv * G * T * Dv * 4      # out f32
    keys = 0
    for b in range(B):
        # row t (position pos0 + t) sees pos0 + t + 1 keys, or w
        keys += sum(min(pos0[b] + t + 1, w) if w > 0 else pos0[b] + t + 1
                    for t in range(nval[b]))
        lo = max(0, pos0[b] - w + 1) if w > 0 else 0
        nbytes += max(0, pos0[b] - lo) * Hkv * (
            (Dq + Dv) * kc.element_size() + 2 * _elem(kw["k_scale"]))
    return nbytes, keys * Hkv * G * 2 * (Dq + Dv)


def decode_work(args, kw):
    """Bytes and operations of one decode call on these inputs: the keys
    in the window (cache below the chain start, then the chain's rows)
    read once (K at D, V at Dv), scored and weighted: 2 x keys x (D + Dv)
    operations a query head."""
    q, kc, vc, kr, vr, meta, win = args
    B, Hkv, G, Dq = q.shape
    Dv = vc.shape[-1]
    w = int(win[0])
    nbytes = q.numel() * q.element_size() + B * Hkv * G * Dv * 4
    keys = 0
    for cpos, nv in meta.tolist():
        cstart = cpos - nv + 1
        lo = max(0, cpos - w + 1) if w > 0 else 0
        n_cache, n_rows = max(0, cstart - lo), min(nv, cpos + 1 - lo)
        keys += n_cache + n_rows
        nbytes += n_cache * Hkv * (
            (Dq + Dv) * kc.element_size() + 2 * _elem(kw["k_scale"]))
        nbytes += n_rows * Hkv * (Dq + Dv) * kr.element_size()
    return nbytes, keys * Hkv * G * 2 * (Dq + Dv)


def _sdpa_mask(qpos, kpos, win, kw, dtype):
    """SDPA's mask for keys kpos from queries qpos: bool (causal, in the
    window) without ALiBi, else a mask [Hkv * G, T, K] in the queries'
    dtype holding each head's slope x (kpos - qpos) and -inf outside."""
    w = int(win[0])
    ok = kpos[None, :] <= qpos[:, None]
    if w > 0:
        ok = ok & (kpos[None, :] > qpos[:, None] - w)
    if kw.get("alibi") is None:
        return ok
    dist = (kpos[None, :] - qpos[:, None]).float()
    m = kw["alibi"].reshape(-1, 1, 1) * dist[None]
    return m.masked_fill(~ok[None], float("-inf")).to(dtype)


def sdpa_prefill(args, kw):
    """SDPA on the same function: keys = cache[:pos0] ++ rows (slots share
    pos0 in the timed cases), a causal mask under the window (a float one
    with ALiBi's bias), GQA; the softcap has no SDPA form and is left
    out."""
    q, kc, vc, kr, vr, meta, win = args
    B, Hkv, G, T, Dq = q.shape
    p0 = int(meta[0, 0])
    k = torch.cat([kc[:, :p0], kr], 1).nan_to_num().transpose(1, 2)
    v = torch.cat([vc[:, :p0], vr], 1).nan_to_num().transpose(1, 2)
    qq = q.reshape(B, Hkv * G, T, Dq)
    kpos = torch.arange(p0 + T, device=q.device)
    mask = _sdpa_mask(p0 + torch.arange(T, device=q.device), kpos, win, kw,
                      q.dtype)
    k, v = k.contiguous(), v.contiguous()
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, enable_gqa=True)


def sdpa_decode(args, kw):
    q, kc, vc, kr, vr, meta, win = args
    B, Hkv, G, Dq = q.shape
    cpos, nv = (int(x) for x in meta[0])
    cs = cpos - nv + 1
    k = torch.cat([kc[:, :cs], kr[:, :nv]], 1).nan_to_num().transpose(1, 2)
    v = torch.cat([vc[:, :cs], vr[:, :nv]], 1).nan_to_num().transpose(1, 2)
    qq = q.reshape(B, Hkv * G, 1, Dq)
    kpos = torch.arange(cs + nv, device=q.device)
    mask = _sdpa_mask(torch.tensor([cpos], device=q.device), kpos, win, kw,
                      q.dtype)
    k, v = k.contiguous(), v.contiguous()
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, enable_gqa=True)


def cold_cached_check(g, dev, T=500, prefix=(137, 64, 1, 300), hkv=HKV,
                      G=H // HKV, d=D, C=SLOT_CTX, win=(0, 0), dv=None):
    """flash_prefill at the served shape: 4 slots of a T-token prompt
    prefilled cold (pos0 0) against the same prompts with their first
    prefix[b] positions already in a bf16 cache and the rest as rows.
    Tiles are aligned to absolute key positions (a tile wholly below a
    row's window skipped), so every output row must be bit-identical.
    Returns the number of rows compared."""
    from llama_box_tpu_torch.ops.flash_prefill import flash_prefill_batched
    B, bf, dv = len(prefix), torch.bfloat16, dv or d
    q = torch.randn(B, hkv, G, T, d, generator=g, device=dev).to(bf)
    kr = torch.randn(B, T, hkv, d, generator=g, device=dev).to(bf)
    vr = torch.randn(B, T, hkv, dv, generator=g, device=dev).to(bf)
    kc = torch.full((B, C, hkv, d), float("nan"), device=dev, dtype=bf)
    vc = torch.full((B, C, hkv, dv), float("nan"), device=dev, dtype=bf)
    win = torch.tensor(win, dtype=torch.int32, device=dev)
    meta = torch.tensor([[0, T, 0, 0]] * B, dtype=torch.int32, device=dev)
    cold = flash_prefill_batched(q, kc, vc, kr, vr, meta, win)
    Tw = T - min(prefix)
    qw = torch.zeros(B, hkv, G, Tw, d, device=dev, dtype=bf)
    krw = torch.zeros(B, Tw, hkv, d, device=dev, dtype=bf)
    vrw = torch.zeros(B, Tw, hkv, dv, device=dev, dtype=bf)
    for b, p in enumerate(prefix):
        kc[b, :p], vc[b, :p] = kr[b, :p], vr[b, :p]
        qw[b, :, :, :T - p] = q[b, :, :, p:]
        krw[b, :T - p], vrw[b, :T - p] = kr[b, p:], vr[b, p:]
    meta = torch.tensor([[p, T - p, 0, 0] for p in prefix],
                        dtype=torch.int32, device=dev)
    warm = flash_prefill_batched(qw, kc, vc, krw, vrw, meta, win)
    torch.cuda.synchronize()
    rows = 0
    for b, p in enumerate(prefix):
        got, want = warm[b, :, :, :T - p], cold[b, :, :, p:]
        if not (torch.isfinite(got).all() and torch.equal(got, want)):
            n = int((got != want).sum())
            raise AssertionError(f"flash_prefill: cached prefix {p} differs "
                                 f"from the cold prefill in {n} elements")
        rows += T - p
    log(f"  flash_prefill cold vs cached prefix {list(prefix)} "
        f"(q[{B},{hkv},{G},{T},{d}] bf16, V {dv}, C={C}, window "
        f"{int(win[0])}): {rows} rows x {G * hkv} heads bit-identical")
    return rows


def chain_rows_check(g, dev, cposes=(17, 1023, 2040), hkv=HKV, G=H // HKV,
                     d=D, C=SLOT_CTX, win=(0, 0), dv=None):
    """flash_decode at the served shape: each query with nv = 16 (its last
    16 keys as chain rows) against the same query with nv = 1 (all but
    its own key in the cache), the rows holding what the cache holds (an
    int8 cache: codes times scale rounded to bf16, as the model's rows).
    Splits and tiles follow absolute positions, so the outputs must be
    bit-identical (greedy K=1 = K=16). Returns the cases compared."""
    from llama_box_tpu_torch.ops.flash_decode import flash_decode
    B, R, bf, dv = 4, CHAIN, torch.bfloat16, dv or d
    n = 0
    for quant in (False, True):
        for cpos in cposes:
            q = torch.randn(B, hkv, G, d, generator=g, device=dev).to(bf)
            kc, vc, ks, vs = make_cache(g, B, C, bf, quant, dev, hkv, d, dv)
            cur = [torch.randn(B, hkv, w, generator=g, device=dev).to(bf)
                   for w in (d, dv)]
            if quant:
                kd = (kc.float() * ks.float()[..., None]).to(bf)
                vd = (vc.float() * vs.float()[..., None]).to(bf)
            else:
                kd, vd = kc, vc
            w = torch.tensor(win, dtype=torch.int32, device=dev)
            out = {}
            for nv in (1, R):
                cs = cpos - nv + 1
                kr = torch.zeros(B, R, hkv, d, device=dev, dtype=bf)
                vr = torch.zeros(B, R, hkv, dv, device=dev, dtype=bf)
                kr[:, :nv - 1], vr[:, :nv - 1] = kd[:, cs:cpos], vd[:, cs:cpos]
                kr[:, nv - 1], vr[:, nv - 1] = cur
                k2, v2, ks2, vs2 = kc.clone(), vc.clone(), ks, vs
                if quant:            # never read: at or past the chain start
                    ks2, vs2 = ks.clone(), vs.clone()
                    ks2[:, cs:], vs2[:, cs:] = float("nan"), float("nan")
                else:
                    k2[:, cs:], v2[:, cs:] = float("nan"), float("nan")
                meta = torch.tensor([[cpos, nv]] * B, dtype=torch.int32,
                                    device=dev)
                out[nv] = flash_decode(q, k2, v2, kr, vr, meta, w,
                                       k_scale=ks2, v_scale=vs2)
            torch.cuda.synchronize()
            a, b = out[1], out[R]
            if not (torch.isfinite(a).all() and torch.equal(a, b)):
                raise AssertionError(
                    f"flash_decode cpos {cpos} ({'int8' if quant else 'bf16'}"
                    f" cache): nv = 1 and nv = {R} differ in "
                    f"{int((a != b).sum())} elements")
            n += 1
    log(f"  flash_decode nv=1 vs nv={R} (q[{B},{hkv},{G},{d}] bf16, V {dv}, "
        f"C={C}, window {win[0]}, cpos {list(cposes)}, bf16 and int8 "
        f"caches): {n} cases bit-identical")
    return n


# the attention variants' shapes (phases 3 and 4): the published heads of
# each family, what its layers pass the kernels, and the cache capacity
ATTN_KERNEL_CASES = {
    # google/gemma-3-1b-pt: 4 / 1 heads of 256; local layers a 512 window,
    # global ones none
    "gemma3-1b local": dict(hkv=1, G=4, d=256, C=4096, win=(512, 0)),
    "gemma3-1b global": dict(hkv=1, G=4, d=256, C=4096),
    # google/gemma-2-2b: 8 / 4 heads of 256, attention softcap 50
    "gemma2-2b softcap": dict(hkv=4, G=2, d=256, C=4096, softcap=50.0),
    # bigscience/bloom-560m: 16 heads of 64, MHA, ALiBi
    "bloom-560m alibi": dict(hkv=16, G=1, d=64, C=2048, alibi=True),
    # microsoft/phi-2: 32 heads of 80; phi-3-mini: 32 heads of 96 (MHA)
    "phi2 d80": dict(hkv=32, G=1, d=80, C=2048),
    "phi3-mini d96": dict(hkv=32, G=1, d=96, C=2048),
}


# multi-head latent attention's shapes (phases 3 and 4): H heads of K at
# nope + rope and of V at value_length (one query head a cache head), C 4096
MLA_KERNEL_CASES = {
    # deepseek-ai/DeepSeek-V2-Lite config.json: 16 heads, qk nope 128 +
    # rope 64, v_head_dim 128
    "deepseek-v2-lite": dict(hkv=16, G=1, d=192, dv=128, C=4096),
    # openbmb/MiniCPM3-4B config.json: 40 heads, qk nope 64 + rope 32,
    # v_head_dim 64
    "minicpm3-4b": dict(hkv=40, G=1, d=96, dv=64, C=4096),
}


def sdpa_backend(fn) -> str:
    """The first SDPA backend, in the order flash, memory-efficient,
    cuDNN, math, that takes fn()'s call, or "refused"."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                fn()
            torch.cuda.synchronize()
            return b.name.lower()
        except RuntimeError:
            continue
    return "refused"


def kernel_phase(dev, seed):
    from llama_box_tpu_torch.ops.flash_decode import (flash_decode,
                                                      flash_decode_plain)
    from llama_box_tpu_torch.ops.flash_prefill import (flash_prefill_batched,
                                                       flash_prefill_plain)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    errs = {"flash_prefill": 0.0, "flash_decode": 0.0}

    def pf(name, atol=BF16_ATOL, **kw):
        args, kws = prefill_case(g, dev, **kw)
        e = check("flash_prefill " + name, flash_prefill_batched,
                  flash_prefill_plain, args, kws, atol,
                  valid=args[5][:, 1].tolist())
        errs["flash_prefill"] = max(errs["flash_prefill"], e)
        return args, kws

    def dc(name, atol=BF16_ATOL, **kw):
        args, kws = decode_case(g, dev, **kw)
        e = check("flash_decode " + name, flash_decode, flash_decode_plain,
                  args, kws, atol)
        errs["flash_decode"] = max(errs["flash_decode"], e)
        return args, kws

    log("== phase 3: kernel vs plain at the slice's shapes")
    main = {}
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        for p0 in (0, 512):
            main[("prefill", tag, p0)] = pf(
                f"{tag} q[4,4,8,512,64] C=2048 pos0={p0}",
                pos0=(p0,) * 4, quant=quant)
        for cp in (17, 1023, 2040):
            main[("decode", tag, cp)] = dc(
                f"{tag} q[4,4,8,64] C=2048 R=16 cpos={cp}",
                cpos=(cp,) * 4, nv=(16, 1, 5, 16) if cp == 17 else (CHAIN,) * 4,
                quant=quant)
    small = dict(B=2, C=256)
    pf("ragged pos0/n_valid", T=80, pos0=(200, 0), n_valid=(80, 33), **small)
    pf("window", T=80, pos0=(150, 40), win=(24, 0), **small)
    pf("chunk", T=80, pos0=(150, 40), win=(0, 32), **small)
    pf("softcap", T=80, pos0=(150, 40), softcap=30.0, **small)
    pf("sinks", T=80, pos0=(150, 40), sinks=True, **small)
    pf("bidir span", T=80, pos0=(150, 40), win=(24, 0),
       spans=((160, 200), (0, 0)), **small)
    pf("f32", T=80, pos0=(150, 40), dtype=torch.float32, atol=F32_ATOL,
       **small)
    dc("window", cpos=(200, 40), nv=(5, 1), win=(24, 0), **small)
    dc("chunk", cpos=(200, 40), nv=(5, 1), win=(0, 32), **small)
    dc("softcap", cpos=(200, 40), nv=(5, 1), softcap=30.0, **small)
    dc("sinks", cpos=(200, 40), nv=(5, 1), sinks=True, **small)
    dc("f32", cpos=(200, 40), nv=(5, 1), dtype=torch.float32,
       atol=F32_ATOL, **small)
    dc("fresh slot", cpos=(0, 3), nv=(1, 4), **small)
    cold_cached_check(g, dev)
    chain_rows_check(g, dev)

    log("== phase 3, attention variants: head widths 80, 96, 256, a "
        "layer's window row, the softcap, ALiBi")
    for name, c in ATTN_KERNEL_CASES.items():
        C = c["C"]
        for p0 in ((0, 1024) if name.startswith("gemma3") else (1024,)):
            main[("prefill", name, p0)] = pf(
                f"{name} q[4,{c['hkv']},{c['G']},512,{c['d']}] C={C} "
                f"pos0={p0}", pos0=(p0,) * 4, **c)
        for cp in ((1023, 3000) if C > 3000 else (1023,)):
            main[("decode", name, cp)] = dc(
                f"{name} q[4,{c['hkv']},{c['G']},{c['d']}] C={C} R=16 "
                f"cpos={cp}", cpos=(cp,) * 4, **c)
    for d in (80, 96, 256):
        v = dict(B=2, C=256, hkv=2, G=2, d=d, win=(24, 0), alibi=True)
        pf(f"d{d} f32 window alibi", T=80, pos0=(150, 40),
           dtype=torch.float32, atol=F32_ATOL, **v)
        pf(f"d{d} int8 window alibi", T=80, pos0=(150, 40), quant=True, **v)
        dc(f"d{d} f32 window alibi", cpos=(200, 40), nv=(5, 1),
           dtype=torch.float32, atol=F32_ATOL, **v)
        dc(f"d{d} int8 window alibi", cpos=(200, 40), nv=(5, 1), quant=True,
           **v)
    cold_cached_check(g, dev, T=700, prefix=(137, 300, 1, 600), hkv=1, G=4,
                      d=256, C=4096, win=(512, 0))
    chain_rows_check(g, dev, cposes=(1023, 3000), hkv=1, G=4, d=256, C=4096,
                     win=(512, 0))

    log("== phase 3, multi-head latent attention: K / V widths 192 / 128 "
        "and 96 / 64")
    for name, c in MLA_KERNEL_CASES.items():
        hkv, d, dv, C = c["hkv"], c["d"], c["dv"], c["C"]
        for quant in (False, True):
            tag = f"{name} {'int8' if quant else 'bf16'}"
            for p0 in (0, 1024):
                main[("prefill", tag, p0)] = pf(
                    f"{tag} q[4,{hkv},1,512,{d}] V {dv} C={C} pos0={p0}",
                    pos0=(p0,) * 4, quant=quant, **c)
            for cp in (1023, 3000):
                main[("decode", tag, cp)] = dc(
                    f"{tag} q[4,{hkv},1,{d}] V {dv} C={C} R=16 cpos={cp}",
                    cpos=(cp,) * 4, quant=quant, **c)
        v = dict(B=2, C=256, hkv=2, G=1, d=d, dv=dv)
        pf(f"{name} f32", T=80, pos0=(150, 40), dtype=torch.float32,
           atol=F32_ATOL, **v)
        pf(f"{name} int8 window", T=80, pos0=(150, 40), quant=True,
           win=(24, 0), **v)
        dc(f"{name} f32", cpos=(200, 40), nv=(5, 1), dtype=torch.float32,
           atol=F32_ATOL, **v)
        dc(f"{name} int8 window", cpos=(200, 40), nv=(5, 1), quant=True,
           win=(24, 0), **v)
        cold_cached_check(g, dev, hkv=hkv, G=1, d=d, dv=dv, C=C)
        chain_rows_check(g, dev, cposes=(1023, 3000), hkv=hkv, G=1, d=d,
                         dv=dv, C=C)

    log("== phase 4: device times (median of 15, a plain version's of 5, "
        "cold L2)")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for key, (args, kws) in main.items():
        kind, tag, pos = key
        if kind == "prefill":
            kern = lambda a=args, k=kws: flash_prefill_batched(*a, **k)
            plain = lambda a=args, k=kws: flash_prefill_plain(*a, **k)
            nbytes, flops = prefill_work(args, kws)
            lib = None if tag.endswith("int8") else sdpa_prefill(args, kws)
        else:
            kern = lambda a=args, k=kws: flash_decode(*a, **k)
            plain = lambda a=args, k=kws: flash_decode_plain(*a, **k)
            nbytes, flops = decode_work(args, kws)
            lib = None if tag.endswith("int8") else sdpa_decode(args, kws)
        b_ms, b_by = bound_ms(nbytes, flops)
        q = args[0]
        r = dict(kind=kind, cache=tag, pos=pos, q=list(q.shape),
                 C=args[1].shape[1],
                 ms=device_ms(kern, flush),
                 plain_ms=device_ms(plain, flush, n=PLAIN_REPS),
                 library_ms=None if lib is None else device_ms(lib, flush),
                 bound_ms=b_ms, bound_by=b_by, mbytes=nbytes / 1e6,
                 gflop=flops / 1e9, dv=args[2].shape[-1])
        if lib is not None and r["dv"] != q.shape[-1]:
            r["sdpa_backend"] = sdpa_backend(lib)
        rows.append(r)
        log("  " + json.dumps(r))
    return errs, rows


# ---------------------------------------------------------------------------
# the w8a8 kernels


def _guarded(shape, dtype, dev, pad=256):
    """(NaN-filled flat buffer, contiguous `shape` view inside it with
    `pad` NaN elements on each side): unwritten outputs stay NaN, stray
    writes hit the guards."""
    n = int(np.prod(shape))
    buf = torch.full((n + 2 * pad,), float("nan"), dtype=dtype, device=dev)
    return buf, buf[pad:pad + n].view(shape)


def _guards_ok(buf, pad=256) -> bool:
    return bool(torch.isnan(buf[:pad].float()).all()
                and torch.isnan(buf[-pad:].float()).all())


class W8Gen:
    """Random w8a8 operands on the card: bf16 rows ~ N(0, 1), int8 codes
    over the full range, column scales that keep outputs near unit size."""

    def __init__(self, dev, seed):
        self.dev = dev
        self.g = torch.Generator(device=dev)
        self.g.manual_seed(seed)

    def rows(self, r, k):
        return torch.randn(r, k, generator=self.g, device=self.dev).to(
            torch.bfloat16)

    def norm(self, k):
        return (torch.rand(k, generator=self.g, device=self.dev) + 0.5).to(
            torch.bfloat16)

    def weights(self, k, n):
        qs = torch.randint(-127, 128, (k, n), generator=self.g,
                           device=self.dev, dtype=torch.int8)
        sc = (torch.rand(n, generator=self.g, device=self.dev) + 0.5) \
            / (73.0 * k ** 0.5)
        return qs, sc


def w8a8_work(kind, shp, out_bytes=2):
    """(bytes, int8 ops) one call needs: inputs read once, outputs written
    once (activations bf16, codes int8, scales f32; w8a8_matmul writes the
    dtype the call asks for, `out_bytes` an element, the fused kernels
    bf16)."""
    if kind == "w8a8_matmul":
        M, K, N = shp
        return M * K * 2 + K * N + N * 4 + M * N * out_bytes, 2 * M * K * N
    if kind == "fused_norm_qmm":
        R, E, O = shp
        return R * E * 2 + E * 2 + E * O + O * 4 + R * O * 2, 2 * R * E * O
    R, HD, E, FF = shp
    w = HD * E + E * 2 * FF + FF * E
    return (2 * R * HD + 2 * R * E + E * 2 + w + (2 * E + 2 * FF) * 4
            + 2 * R * E, 2 * R * w)


def call_kernels(fn) -> dict:
    """Kernel name -> (device ms, launches) of one call of fn()
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0}


def launches_per_call(fn) -> int:
    """Kernels one call of fn() runs on the card."""
    return sum(n for _, n in call_kernels(fn).values())


def w8a8_kernel_phase(dev, seed, shapes=None):
    """Phase 3 and 4 for the w8a8 kernels. Returns (max errors, timing
    rows). `shapes` overrides the slice's shapes (a smaller rehearsal);
    `timed` lists the fused shapes phase 4w times (the served ones and
    Llama-3-8B's widths)."""
    from llama_box_tpu_torch.ops.fused_decode import (
        fused_layer_tail, fused_layer_tail_plain, fused_norm_qmm,
        fused_norm_qmm_plain, tail_xnew_plain)
    from llama_box_tpu_torch.ops.qmatmul import (w8a8_matmul,
                                                 w8a8_matmul_plain,
                                                 w8a8_quant_rows)
    shapes = shapes or dict(
        mm=[(M, K, N) for M in (2048, 512, 4) for K, N in
            ((E, (H + 2 * HKV) * D), (H * D, E), (E, 2 * FF), (FF, E))],
        nq=[(4, E, (H + 2 * HKV) * D), (4, E, V), (1, E, 2560),
            (64, E, 2560), (9, E, 2560), (4, E8, 6144), (4, E8, V8)],
        tail=[(4, H * D, E, FF, "silu", 1.0), (1, 256, 256, 384, "gelu", 0.5),
              (64, 256, 256, 200, "relu2", 1.0), (4, 256, 256, 384, "silu", 0.5),
              (9, H * D, E, FF, "silu", 1.0), (4, E8, E8, FF8, "silu", 1.0)],
        timed=[(4, E, (H + 2 * HKV) * D), (4, E, V), (4, E8, 6144),
               (4, E8, V8), (4, H * D, E, FF), (4, E8, E8, FF8)])
    gen = W8Gen(dev, seed + 100)
    errs = {"w8a8_matmul": 0.0, "fused_norm_qmm": 0.0,
            "fused_layer_tail": 0.0}
    cases = []
    log("== phase 3w: w8a8 kernels vs plain (NaN output guards / scratch)")
    mm_cases = []
    for M, K, N in shapes["mm"]:
        x = gen.rows(M, K)
        qs, sc = gen.weights(K, N)
        want = w8a8_matmul_plain(x, qs, sc)
        for odt in (torch.float32, torch.bfloat16):
            buf, out = _guarded((M, N), odt, dev)
            got = w8a8_matmul(x, qs, sc, out=out, out_dtype=odt)
            torch.cuda.synchronize()
            ref = want.to(odt)
            assert torch.isfinite(got.float()).all() and _guards_ok(buf), (
                M, K, N, odt)
            err = float((got.float() - ref.float()).abs().max())
            log(f"  w8a8_matmul x[{M},{K}] qs[{K},{N}] {str(odt)[6:]:<9s} "
                f"out max_abs_err {err:.3e}  (bit-equal required)")
            if not torch.equal(got, ref):
                raise AssertionError(f"w8a8_matmul {(M, K, N)} {odt}: not "
                                     f"bit-equal to its plain version ({err})")
            errs["w8a8_matmul"] = max(errs["w8a8_matmul"], err)
        mm_cases.append(((M, K, N), x, qs, sc))
    for R, E_, O in shapes["nq"]:
        x, nw = gen.rows(R, E_), gen.norm(E_)
        qs, sc = gen.weights(E_, O)
        buf, out = _guarded((R, O), torch.bfloat16, dev)
        got = fused_norm_qmm(x, nw, qs, sc, eps=1e-5, out=out)
        want = fused_norm_qmm_plain(x, nw, qs, sc, eps=1e-5)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all() and _guards_ok(buf)
        err = float((got.float() - want.float()).abs().max())
        log(f"  fused_norm_qmm x[{R},{E_}] qs[{E_},{O}]{'':<10s} max_abs_err "
            f"{err:.3e}  (tol {NORM_QMM_TOL:g} + rel, argmax)")
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=NORM_QMM_TOL, atol=NORM_QMM_TOL)
        assert torch.equal(got.float().argmax(-1), want.float().argmax(-1))
        errs["fused_norm_qmm"] = max(errs["fused_norm_qmm"], err)
        cases.append(("fused_norm_qmm", (R, E_, O),
                      lambda a=(x, nw, qs, sc): fused_norm_qmm(*a, eps=1e-5),
                      lambda a=(x, nw, qs, sc): fused_norm_qmm_plain(
                          *a, eps=1e-5), None))
    for R, HD, E_, FF_, act_fn, rs in shapes["tail"]:
        ao, xr, nw = gen.rows(R, HD), gen.rows(R, E_), gen.norm(E_)
        ws = (*gen.weights(HD, E_), nw, *gen.weights(E_, 2 * FF_),
              *gen.weights(FF_, E_))
        kw = dict(eps=1e-5, rs=rs, act_fn=act_fn)
        obuf, out = _guarded((R, E_), torch.bfloat16, dev)
        xbuf, xnew = _guarded((R, E_), torch.bfloat16, dev)
        abuf, act = _guarded((R, FF_), torch.bfloat16, dev)
        got = fused_layer_tail(ao, xr, *ws, out=out, scratch=(xnew, act),
                               **kw)
        want = fused_layer_tail_plain(ao, xr, *ws, **kw)
        torch.cuda.synchronize()
        assert all(_guards_ok(b) for b in (obuf, xbuf, abuf))
        assert torch.isfinite(xnew.float()).all() \
            and torch.isfinite(act.float()).all() \
            and torch.isfinite(got.float()).all()
        err = float((got.float() - want.float()).abs().max())
        log(f"  fused_layer_tail R={R} HD={HD} E={E_} FF={FF_} {act_fn} "
            f"rs={rs}{'':<3s} max_abs_err {err:.3e}  (tol {TAIL_TOL:g} + rel;"
            " xnew bit-equal)")
        # phase A has no norm: its xnew rows are the plain ones, bit for bit
        if not torch.equal(xnew, tail_xnew_plain(ao, xr, *ws[:2], rs=rs)):
            raise AssertionError(f"fused_layer_tail {(R, HD, E_, FF_)}: "
                                 "xnew differs from the plain version's")
        torch.testing.assert_close(got.float(), want.float(), rtol=TAIL_TOL,
                                   atol=TAIL_TOL)
        errs["fused_layer_tail"] = max(errs["fused_layer_tail"], err)
        cases.append(("fused_layer_tail", (R, HD, E_, FF_),
                      lambda a=(ao, xr, *ws), k=kw: fused_layer_tail(*a, **k),
                      lambda a=(ao, xr, *ws), k=kw: fused_layer_tail_plain(
                          *a, **k), None))

    log("== phase 4w: w8a8 device times (median of 15, a plain version's "
        "of 5, cold L2)")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for (M, K, N), x, qs, sc in mm_cases:
        # yardsticks (never used by the port): torch._int_mm on the codes
        # with the weight as stored ([K, N] row-major) and as cuBLASLt's
        # int8 path takes it (a K-major copy, made once); torch.matmul in
        # bf16 on the dequantized weight, the dense path's cost
        xq = w8a8_quant_rows(x)[0][:, :K].contiguous()
        qs_km = qs.t().contiguous().t()
        wf = (qs.float() * sc[None, :]).to(torch.bfloat16)
        yard = {}
        for key, fn in (("int_mm_ms", lambda: torch._int_mm(xq, qs)),
                        ("int_mm_kmajor_ms", lambda: torch._int_mm(xq, qs_km)),
                        ("matmul_bf16_ms", lambda: torch.matmul(x, wf))):
            yard[key] = None
            if key != "matmul_bf16_ms" and not (M > 16 and K % 8 == 0
                                                and N % 8 == 0):
                continue
            try:
                yard[key] = device_ms(fn, flush)
            except RuntimeError as exc:    # the yardstick refused the shape
                log(f"  {key} refused {(M, K, N)}: {exc}")
        q_bytes = M * K * 3 + 4 * M
        quant = dict(quant_ms=device_ms(lambda: w8a8_quant_rows(x), flush),
                     quant_bound_ms=q_bytes / HBM_BPS * 1e3,
                     quant_mbytes=q_bytes / 1e6)
        for odt in (torch.float32, torch.bfloat16):
            nbytes, ops = w8a8_work("w8a8_matmul", (M, K, N),
                                    torch.finfo(odt).bits // 8)
            b_ms, b_by = bound_ms(nbytes, ops, INT8_OPS)
            kern = lambda o=odt: w8a8_matmul(x, qs, sc, out_dtype=o)  # noqa: E731
            calls = call_kernels(kern)
            r = dict(kind="w8a8_matmul", shape=[M, K, N], out=str(odt)[6:],
                     ms=device_ms(kern, flush),
                     plain_ms=device_ms(lambda o=odt: w8a8_matmul_plain(
                         x, qs, sc).to(o), flush, n=PLAIN_REPS),
                     library_ms=yard["int_mm_kmajor_ms"], bound_ms=b_ms,
                     bound_by=b_by, mbytes=nbytes / 1e6, gop=ops / 1e9,
                     kernels_per_call=sum(n for _, n in calls.values()),
                     kernels_ms_warm={k: v[0] for k, v in calls.items()},
                     **yard, **quant)
            rows.append(r)
            log("  " + json.dumps(r))
        del xq, qs_km, wf
    timed = {tuple(t) for t in shapes.get("timed", ())}
    for name, shp, kern, plain, lib in cases:
        if tuple(shp) not in timed:
            continue                      # served and 8B-width shapes only
        nbytes, ops = w8a8_work(name, shp)
        b_ms, b_by = bound_ms(nbytes, ops, INT8_OPS)
        r = dict(kind=name, shape=list(shp), ms=device_ms(kern, flush),
                 plain_ms=device_ms(plain, flush, n=PLAIN_REPS),
                 library_ms=None,
                 bound_ms=b_ms, bound_by=b_by, mbytes=nbytes / 1e6,
                 gop=ops / 1e9, kernels_per_call=launches_per_call(kern))
        rows.append(r)
        log("  " + json.dumps(r))
    return errs, rows


# ---------------------------------------------------------------------------
# the grouped kernels


class QGen:
    """Random grouped operands on the card: bf16 rows ~ N(0, 1); codes
    `q4` (packed bytes), `q4int8` (0..15), `q6` (-32..31) or `q8`
    (-127..127); scales (and mins near the codes' middle) that keep
    outputs near unit size."""

    CODES = {"q4int8": (0, 16, 4.6), "q6": (-32, 32, 18.5),
             "q8": (-127, 128, 73.0)}

    def __init__(self, dev, seed):
        self.dev = dev
        self.g = torch.Generator(device=dev)
        self.g.manual_seed(seed)

    def rows(self, m, k, dtype=torch.bfloat16):
        return torch.randn(m, k, generator=self.g, device=self.dev).to(dtype)

    def weight(self, k, n, codes, group, mins, sdt):
        if codes == "q4":
            qs = torch.randint(-128, 128, (k // 2, n), generator=self.g,
                               device=self.dev, dtype=torch.int8)
            spread = 4.6
        else:
            lo, hi, spread = self.CODES[codes]
            qs = torch.randint(lo, hi, (k, n), generator=self.g,
                               device=self.dev, dtype=torch.int8)
        sc = (torch.rand(k // group, n, generator=self.g, device=self.dev)
              + 0.5) / (spread * k ** 0.5)
        mn = (sc * (torch.rand(sc.shape, generator=self.g, device=self.dev)
                    * 3 + 6)).to(sdt) if mins else None
        return qs, sc.to(sdt), mn


def q_cases():
    """(label, M, K, N, codes, group, mins, scale dtype, x dtype, timed)."""
    bf, f32 = torch.bfloat16, torch.float32
    served = [("wqkv", E, (H + 2 * HKV) * D, "q4", 32, True),
              ("wo", H * D, E, "q4", 32, True),
              ("gate|up", E, 2 * FF, "q4", 32, True),
              ("down", FF, E, "q6", 16, False)]
    cases = [(lbl, M, K, N, c, g, mn, bf, bf, True)
             for M in (2048, 4) for lbl, K, N, c, g, mn in served]
    cases.append(("output", 4, E, V, "q6", 16, False, bf, bf, True))
    cases += [("q4 f32 scales", 1, 512, 320, "q4", 32, True, f32, bf, False),
              ("q4 no mins", 64, 512, 320, "q4", 32, False, bf, bf, False),
              ("q4 as int8 codes", 4, E, 4160, "q4int8", 32, True, bf, bf,
               False),
              ("q8_0 f32 scales", 64, 1024, 4160, "q8", 32, False, f32, bf,
               False),
              ("q6_k f32 rows", 1, FF, 320, "q6", 16, False, bf, f32, False),
              ("q6_k 200 rows", 200, E, 4160, "q6", 16, False, bf, bf, False),
              ("q4 200 rows", 200, E, 4160, "q4", 32, True, bf, bf, False)]
    for M in (4, 2048):
        cases += [("8B gate|up", M, E8, 2 * FF8, "q4", 32, True, bf, bf, True),
                  ("8B down", M, FF8, E8, "q6", 16, False, bf, bf, True),
                  ("8B output", M, E8, V8, "q6", 16, False, bf, bf, True)]
    return cases


def q_work(x, qs, sc, mn, N, out_dtype=torch.float32):
    """(bytes, operations) of one call: x, codes, scales and mins read
    once, the output written once; 2*M*K*N operations."""
    M, K = x.shape
    nbytes = (x.numel() * x.element_size() + qs.numel()
              + sc.numel() * sc.element_size() * (2 if mn is not None else 1)
              + M * N * torch.finfo(out_dtype).bits // 8)
    return nbytes, 2 * M * K * N


def q_kernel_phase(dev, seed):
    """Phases 3q and 4q. Returns (max errors, timing rows)."""
    from llama_box_tpu_torch.ops.qmatmul import (_dequant_f32, q4_matmul,
                                                 q4_matmul_plain, q8_matmul,
                                                 q8_matmul_plain)
    gen = QGen(dev, seed + 200)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    errs = {"q4_matmul": 0.0, "q8_matmul": 0.0}
    rows = []
    log("== phase 3q/4q: grouped kernels vs plain (NaN output guards), "
        "then device times (median of 15, a plain version's of 5, cold L2) "
        "of the timed shapes")
    for lbl, M, K, N, codes, group, mins, sdt, xdt, timed in q_cases():
        packed = codes == "q4"
        name = "q4_matmul" if packed else "q8_matmul"
        kern, plain = ((q4_matmul, q4_matmul_plain) if packed
                       else (q8_matmul, q8_matmul_plain))
        x = gen.rows(M, K, xdt)
        qs, sc, mn = gen.weight(K, N, codes, group, mins, sdt)
        buf, out = _guarded((M, N), torch.float32, dev)
        got = kern(x, qs, sc, mn, group, out=out)
        want = plain(x, qs, sc, mn, group)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and _guards_ok(buf), (lbl, M)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        tol = Q_REL * scale
        log(f"  {name} {lbl:<16s} x[{M},{K}] {str(xdt)[6:]:<8s} N={N:<6d} "
            f"group {group} {'mins' if mins else 'no mins'} "
            f"{str(sdt)[6:]} scales: max_abs_err {err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"{name} {lbl} M={M}: max_abs_err {err} "
                                 f"> {tol}")
        errs[name] = max(errs[name], err)
        b16 = kern(x, qs, sc, mn, group, out_dtype=torch.bfloat16)
        if not torch.equal(b16, got.to(torch.bfloat16)):
            raise AssertionError(f"{name} {lbl} M={M}: bf16 output is not the "
                                 "f32 output rounded")
        del got, want, buf, out, b16
        if timed:
            w = _dequant_f32(qs, sc, mn, group, packed).to(torch.bfloat16)
            for odt in (torch.float32, torch.bfloat16):
                nbytes, ops = q_work(x, qs, sc, mn, N, odt)
                b_ms, b_by = bound_ms(nbytes, ops)
                r = dict(kind=name, label=lbl, shape=[M, K, N],
                         out=str(odt)[6:],
                         ms=device_ms(lambda: kern(x, qs, sc, mn, group,
                                                   out_dtype=odt), flush),
                         plain_ms=device_ms(lambda: plain(
                             x, qs, sc, mn, group).to(odt), flush,
                             n=PLAIN_REPS),
                         library_ms=device_ms(lambda: torch.matmul(x, w),
                                              flush),
                         bound_ms=b_ms, bound_by=b_by, mbytes=nbytes / 1e6,
                         gflop=ops / 1e9)
                rows.append(r)
                log("  " + json.dumps(r))
            del w
    return errs, rows


# ---------------------------------------------------------------------------
# synthetic TinyLlama-1.1B-width GGUF


def spm_vocab(n_vocab: int = V):
    """<unk>, <s>, </s>, 256 byte-fallback pieces, the chatml markers, then
    letter pieces up to n_vocab (shorter first, scored by rank)."""
    from llama_box_tpu_torch.tokenizer.tokenizer import TokenType
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)] \
        + ["<|im_start|>", "<|im_end|>"]
    types = [TokenType.UNKNOWN, TokenType.CONTROL, TokenType.CONTROL] \
        + [TokenType.BYTE] * 256 + [TokenType.CONTROL] * 2
    alpha = ["▁"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    pieces = list(alpha)
    pieces += [a + b for a in alpha for b in alpha]
    pieces += [a + b + c for a in alpha for b in alpha[1:] for c in alpha[1:]]
    pieces += ["▁" + a + b + c for a in alpha[1:] for b in alpha[1:]
               for c in alpha[1:]]
    if len(pieces) < n_vocab - len(toks):
        pieces += ["▁" + a + b + c + d for a in alpha[1:] for b in alpha[1:]
                   for c in alpha[1:] for d in alpha[1:]]
    pieces = pieces[:n_vocab - len(toks)]
    scores = [0.0] * len(toks) + [-float(i) for i in range(len(pieces))]
    return toks + pieces, scores, types + [TokenType.NORMAL] * len(pieces)


# the 2D weights' types of each synthetic file: (most weights, output and
# ffn_down); q4_k_m gives each layer key one type, Q6_K where llama.cpp's
# Q4_K_M gives it to output and (about half of the layers') ffn_down
MODEL_TYPES = {"f16": ("F16", "F16"), "q8_0": ("Q8_0", "Q8_0"),
               "q4_k_m": ("Q4_K", "Q6_K")}


def _model_path(tmp: str, fmt: str) -> str:
    return f"{tmp}/synthetic-tinyllama-1.1b-{fmt}.gguf"


def write_model(path: str, seed: int, fmt: str = "f16",
                n_layers: int = L) -> None:
    """The synthetic model with the 2D weight types of MODEL_TYPES[fmt]
    (the same random floats, from the same seed, in every format); with
    fewer layers, the same model's first n_layers (a draft model)."""
    from llama_box_tpu_torch.gguf import GGMLType, GGUFWriter
    rng = np.random.default_rng(seed)
    vocab, scores, types = spm_vocab()
    w = GGUFWriter(path, architecture="llama")
    for k, v in (("general.name", "synthetic-tinyllama-1.1b"),
                 ("llama.block_count", n_layers),
                 ("llama.context_length", 2048),
                 ("llama.embedding_length", E),
                 ("llama.feed_forward_length", FF),
                 ("llama.attention.head_count", H),
                 ("llama.attention.head_count_kv", HKV),
                 ("llama.attention.layer_norm_rms_epsilon", 1e-5),
                 ("llama.rope.freq_base", 10000.0),
                 ("llama.rope.dimension_count", D),
                 ("llama.vocab_size", V), ("tokenizer.ggml.model", "llama"),
                 ("tokenizer.ggml.tokens", vocab),
                 ("tokenizer.ggml.scores", np.asarray(scores, np.float32)),
                 ("tokenizer.ggml.token_type", np.asarray(types, np.int32)),
                 ("tokenizer.ggml.bos_token_id", 1),
                 ("tokenizer.ggml.eos_token_id", 2),
                 ("tokenizer.ggml.unknown_token_id", 0),
                 ("tokenizer.ggml.add_bos_token", True),
                 ("tokenizer.chat_template", CHATML)):
        w.add_kv(k, v)

    def rand(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    def norm_w():
        return 1.0 + rng.standard_normal(E, dtype=np.float32) * 0.02

    f16, q6 = (GGMLType[t] for t in MODEL_TYPES[fmt])
    w.add_tensor("token_embd.weight", rand(V, E), f16)
    w.add_tensor("output_norm.weight", norm_w())
    w.add_tensor("output.weight", rand(V, E), q6)
    for i in range(n_layers):
        w.add_tensor(f"blk.{i}.attn_norm.weight", norm_w())
        w.add_tensor(f"blk.{i}.attn_q.weight", rand(H * D, E), f16)
        w.add_tensor(f"blk.{i}.attn_k.weight", rand(HKV * D, E), f16)
        w.add_tensor(f"blk.{i}.attn_v.weight", rand(HKV * D, E), f16)
        w.add_tensor(f"blk.{i}.attn_output.weight", rand(E, H * D), f16)
        w.add_tensor(f"blk.{i}.ffn_norm.weight", norm_w())
        w.add_tensor(f"blk.{i}.ffn_gate.weight", rand(FF, E), f16)
        w.add_tensor(f"blk.{i}.ffn_up.weight", rand(FF, E), f16)
        w.add_tensor(f"blk.{i}.ffn_down.weight", rand(E, FF), q6)
    w.write()


def make_prompt(tok, rng, n_target: int) -> str:
    """User text of random letter words whose chat prompt is close to
    n_target tokens (<= the 512-token ubatch)."""
    words = ["".join(chr(ord("a") + c) for c in rng.integers(0, 26, n))
             for n in rng.integers(2, 7, 2 * n_target)]
    lo, hi = 1, len(words)
    while lo < hi:                     # most words whose prompt fits
        mid = (lo + hi + 1) // 2
        if len(tok.encode(" ".join(words[:mid]))) <= n_target - 12:
            lo = mid
        else:
            hi = mid - 1
    return " ".join(words[:lo])


# ---------------------------------------------------------------------------
# end to end


def http(url, body, timeout=600, headers=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        status, text = r.status, r.read().decode()
    return status, text, (time.perf_counter() - t0) * 1e3


def concurrently(fns):
    out = [None] * len(fns)
    errs = []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as exc:  # re-raised below, in the main thread
            errs.append(exc)
    threads = [threading.Thread(target=run, args=(i, f))
               for i, f in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def greedy_run(engine_cls, ecfg, cfg, params, tok, prompts, max_tokens,
               dev):
    eng = engine_cls(cfg, params, tok, ecfg, device=str(dev))
    eng.start()
    try:
        return greedy_on(eng, tok, prompts, max_tokens)
    finally:
        eng.stop()


def greedy_on(eng, tok, prompts, max_tokens):
    """The generated tokens of greedy requests for `prompts` (token lists)
    on a started engine."""
    from llama_box_tpu_torch.sampling import SamplerParams
    from llama_box_tpu_torch.server.task import CompletionsTask
    tasks = [CompletionsTask(p, SamplerParams(temp=0.0, ignore_eos=True),
                             tokenizer=tok, max_tokens=max_tokens)
             for p in prompts]
    for t in tasks:
        eng.submit(t)
    out = []
    for t in tasks:
        while True:
            kind, payload = t.result_q.get(timeout=600)
            if kind == "error":
                raise payload
            if kind == "final":
                out.append(list(payload.generated))
                break
    return out


def small_forward(params, cfg, device, kv_dtype):
    """Two prefill chunks, then one decode step, on a small input (2
    slots, 16-token chunks, a 64-position cache) at full width. Returns
    the logits [6, V] f32 on the CPU."""
    from llama_box_tpu_torch.models import llama
    S, T, C = 2, 16, 64
    rng = np.random.default_rng(5)
    toks = rng.integers(3, cfg.vocab_size, (3, S, T)).astype(np.int32)
    chunks = [(np.zeros(S, np.int64), np.array([T, 11])),
              (np.array([T, 11]), np.array([T, 7]))]
    kv = llama.init_kv_cache(cfg, S, C, kv_dtype, device=device)
    cos, sin = llama.make_rope(cfg, C, device=device)
    out = []
    for i, (p, n) in enumerate(chunks):
        lg, kv = llama.prefill_batch_impl(params, cfg,
                                          torch.from_numpy(toks[i]), p, n,
                                          kv, cos, sin)
        out.append(lg.float().cpu())
    lg, kv = llama.forward_impl(params, cfg, torch.from_numpy(toks[2, :, :1]),
                                np.array([[2 * T], [18]]), kv, cos, sin)
    out.append(lg[:, 0].float().cpu())
    return torch.cat(out)


def _moved(tree, device, dtype=None):
    """The param tree on `device` (dense leaves cast to `dtype` if given;
    QTensors moved as they are)."""
    from llama_box_tpu_torch.ops.qmatmul import QTensor
    if isinstance(tree, dict):
        return {k: _moved(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.to(device)
    return tree.to(device, dtype) if dtype is not None else tree.to(device)


def _cosine(a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(a, b).min())


def reference_check(engine, dev):
    """The card's f32 logits (kernels, cuBLAS f32) against the same model
    on the CPU (plain versions), on small_forward's input."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = engine.cfg
    want = small_forward(_moved(engine.params, "cpu", torch.float32), cfg,
                         "cpu", torch.float32)
    got32 = small_forward(_moved(engine.params, dev, torch.float32), cfg,
                          dev, torch.float32)
    got16 = small_forward(engine.params, cfg, dev, torch.bfloat16)
    assert got32.shape == (6, V) and torch.isfinite(got32).all()
    assert torch.isfinite(got16).all()
    scale = float(want.abs().max())
    e32 = float((got32 - want).abs().max())
    e16 = float((got16 - want).abs().max())
    cos16 = _cosine(got16, want)
    log(f"  f32 card vs f32 CPU: max_abs_err {e32:.3e} (|logit| max "
        f"{scale:.3f}, tol {1e-3 * max(1.0, scale):.3e})")
    log(f"  bf16 card vs f32 CPU: max_abs_err {e16:.3e}, min cosine "
        f"{cos16:.6f} (tol 0.99)")
    assert e32 <= 1e-3 * max(1.0, scale), e32
    assert cos16 >= 0.99, cos16
    return e32, e16


def w8a8_reference_check(engine, dev):
    """The card's w8a8 logits (all five kernels) against the plain versions
    on the CPU over the same QTensors, and the fused kernels against
    LLAMA_BOX_TPU_NO_FUSED on the card, on small_forward's input (bf16
    activations and cache)."""
    cfg = engine.cfg
    want = small_forward(_moved(engine.params, "cpu"), cfg, "cpu",
                         torch.bfloat16)
    got = small_forward(engine.params, cfg, dev, torch.bfloat16)
    os.environ["LLAMA_BOX_TPU_NO_FUSED"] = "1"
    try:
        unfused = small_forward(engine.params, cfg, dev, torch.bfloat16)
    finally:
        del os.environ["LLAMA_BOX_TPU_NO_FUSED"]
    assert got.shape == (6, V) and torch.isfinite(got).all()
    assert torch.isfinite(unfused).all()
    scale = float(want.abs().max())
    e_cpu, c_cpu = float((got - want).abs().max()), _cosine(got, want)
    e_uf, c_uf = float((got - unfused).abs().max()), _cosine(got, unfused)
    agree = float((got.argmax(-1) == unfused.argmax(-1)).float().mean())
    log(f"  w8a8 card vs plain versions on the CPU: max_abs_err {e_cpu:.3e} "
        f"(|logit| max {scale:.3f}), min cosine {c_cpu:.6f} (tol 0.99)")
    log(f"  fused vs LLAMA_BOX_TPU_NO_FUSED on the card: max_abs_err "
        f"{e_uf:.3e}, min cosine {c_uf:.6f} (tol 0.99), argmax agreement "
        f"{agree:.3f} (not asserted: random weights give near ties)")
    assert c_cpu >= 0.99, c_cpu
    assert c_uf >= 0.99, c_uf
    return dict(ref_cpu_max_abs_err=e_cpu, ref_cpu_min_cos=c_cpu,
                fused_vs_unfused_max_abs_err=e_uf,
                fused_vs_unfused_min_cos=c_uf,
                fused_vs_unfused_argmax_agree=agree)


def q4_reference_check(engine, dev):
    """The card's grouped logits (q4_matmul, q8_matmul and the attention
    kernels) against the CPU path over the same QTensors (q_matmul_ref,
    f32 dequantization), on small_forward's input (bf16 activations and
    cache)."""
    cfg = engine.cfg
    want = small_forward(_moved(engine.params, "cpu"), cfg, "cpu",
                         torch.bfloat16)
    got = small_forward(engine.params, cfg, dev, torch.bfloat16)
    assert got.shape == (6, V) and torch.isfinite(got).all()
    scale = float(want.abs().max())
    err, cos = float((got - want).abs().max()), _cosine(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"  q4 card vs q_matmul_ref on the CPU: max_abs_err {err:.3e} "
        f"(|logit| max {scale:.3f}), min cosine {cos:.6f} (tol 0.99), "
        f"argmax agreement {agree:.3f} (not asserted: the kernels round "
        "the weights to bf16, the CPU path does not)")
    assert cos >= 0.99, cos
    return dict(ref_cpu_max_abs_err=err, ref_cpu_min_cos=cos,
                ref_cpu_argmax_agree=agree)


def kernel_counters() -> dict:
    """name -> the wrapper whose `launches` counts the kernel."""
    from llama_box_tpu_torch.ops.flash_decode import flash_decode
    from llama_box_tpu_torch.ops.flash_prefill import flash_prefill_batched
    from llama_box_tpu_torch.ops.fused_decode import (fused_layer_tail,
                                                      fused_norm_qmm)
    from llama_box_tpu_torch.ops.moe import moe_ffn
    from llama_box_tpu_torch.ops.norm import row_norm
    from llama_box_tpu_torch.ops.qmatmul import (q4_matmul, q8_matmul,
                                                 w8a8_matmul)
    from llama_box_tpu_torch.ops.ssm_scan import ssm_scan
    from llama_box_tpu_torch.ops.wkv import wkv_kernel
    return {"flash_prefill": flash_prefill_batched,
            "flash_decode": flash_decode, "w8a8_matmul": w8a8_matmul,
            "fused_norm_qmm": fused_norm_qmm,
            "fused_layer_tail": fused_layer_tail, "q4_matmul": q4_matmul,
            "q8_matmul": q8_matmul, "row_norm": row_norm, "moe_ffn": moe_ffn,
            "ssm_scan": ssm_scan, "wkv": wkv_kernel}


# each served path: phase name, GGUF types, extra CLI flags, environment,
# and the kernels its main path must launch (all others: none)
PATHS = {
    "bf16": ("5", "f16", [], {}, ("flash_prefill", "flash_decode",
                                  "row_norm")),
    "w8a8": ("5w", "q8_0", ["--weights-dtype", "quantized"], {},
             ("flash_prefill", "flash_decode", "w8a8_matmul",
              "fused_norm_qmm", "fused_layer_tail", "row_norm")),
    "q4": ("5q", "q4_k_m", ["--weights-dtype", "quantized"],
           {"LLAMA_BOX_TPU_PACKED4": "1"},
           ("flash_prefill", "flash_decode", "q4_matmul", "q8_matmul",
            "row_norm")),
}


def e2e_phase(dev, seed, tmp, profile=False, mode="bf16"):
    from llama_box_tpu_torch import cli

    phase, fmt, flags, env, _ = PATHS[mode]
    log(f"== phase {phase}: end to end, {mode} path ({fmt} GGUF"
        f"{', ' + ' '.join(flags) if flags else ''}"
        f"{', ' + ' '.join(f'{k}={v}' for k, v in env.items()) if env else ''})")
    path = _model_path(tmp, fmt)      # written beside the kernel phases
    t0 = time.perf_counter()
    os.environ.update(env)            # the residency switches: load time
    try:
        engine, srv = cli.build_server([
            "-m", path, "--port", "0", "-np", str(N_SLOTS), "-c", str(N_CTX),
            "-ub", str(N_UBATCH), "--decode-chain", str(CHAIN), "--no-jinja",
            "--device", dev.type] + flags)
    finally:
        for k in env:
            del os.environ[k]
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    log(f"  server up at {url} in {time.perf_counter() - t0:.1f} s "
        f"(params on {engine.device}, kv {engine.kv.k.dtype})")
    routes = srv.RequestHandlerClass.routes
    try:
        return (*_serve(engine, routes, url, seed, dev, profile, mode),
                (engine, routes))
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
        thread.join(timeout=30)


def run_wave(url, texts, seed):
    """The traffic of every path: 4 concurrent greedy chats of texts 0, 1,
    2, 0 (64 tokens each), then an SSE stream of text 1 beside a sampled
    request of text 2 (seeded). Checks the responses; returns the greedy
    contents, the streamed and the sampled text, the four bodies and the
    first wave's wall seconds."""
    def chat(text, **kw):
        body = dict(messages=[{"role": "user", "content": text}],
                    max_tokens=64, temperature=0, ignore_eos=True)
        body.update(kw)
        return http(url + "/v1/chat/completions", body)

    t0 = time.perf_counter()
    wave1 = concurrently([lambda t=t: chat(t) for t in
                          (texts[0], texts[1], texts[2], texts[0])])
    t_wave1 = time.perf_counter() - t0
    wave2 = concurrently([
        lambda: chat(texts[1], stream=True,
                     stream_options={"include_usage": True}),
        lambda: chat(texts[2], temperature=0.8, seed=seed, ignore_eos=False)])
    t_all = time.perf_counter() - t0
    bodies = []
    for st, text, ms in wave1:
        assert st == 200, st
        b = json.loads(text)
        assert b["usage"]["completion_tokens"] == 64, b["usage"]
        assert b["choices"][0]["message"]["content"], b
        b["client_ms"] = ms
        bodies.append(b)
    c = [b["choices"][0]["message"]["content"] for b in bodies]
    assert c[3] == c[0], "a repeated greedy request gave another text"
    st, sse, _ = wave2[0]
    lines = [x[6:] for x in sse.split("\n") if x.startswith("data: ")]
    assert st == 200 and lines[-1] == "[DONE]", lines[-3:]
    events = [json.loads(x) for x in lines[:-1]]
    streamed = "".join(ch["delta"].get("content", "") for e in events
                       for ch in e["choices"])
    assert streamed and events[-1]["usage"]["completion_tokens"] == 64
    st, text, _ = wave2[1]
    sampled = json.loads(text)
    assert st == 200 and sampled["usage"]["completion_tokens"] > 0
    log(f"  wave 1: 4 greedy chats, prompt tokens "
        f"{[b['usage']['prompt_tokens'] for b in bodies]}, 64 tokens each, "
        f"{t_wave1:.2f} s wall; repeated request identical")
    log(f"  wave 2: SSE stream ({len(events)} events, [DONE]) + sampled "
        f"request ({sampled['usage']['completion_tokens']} tokens)")
    n_gen = (sum(b["usage"]["completion_tokens"] for b in bodies)
             + events[-1]["usage"]["completion_tokens"]
             + sampled["usage"]["completion_tokens"])
    return dict(greedy=c, streamed=streamed,
                sampled=sampled["choices"][0]["message"]["content"],
                bodies=bodies, wall_s=t_wave1, wall_all_s=t_all,
                n_generated=n_gen)


def wave_metrics(w, m) -> dict:
    """End-to-end numbers of a wave: TTFT p50 of the four greedy chats,
    prompt and generated tokens over the engine's prefill and decode
    wall time, and the window: every generated token of both waves over
    their wall time, on the client's clock."""
    ttft = [b["usage"]["time_to_first_token_ms"] for b in w["bodies"]]
    return dict(
        ttft_p50_ms=statistics.median(ttft), ttft_ms=ttft,
        prefill_tok_s=m["n_prefill_total"] / m["t_prefill_total_ms"] * 1e3,
        decode_tok_s=m["n_decode_total"] / m["t_decode_total_ms"] * 1e3,
        prefill_tokens=m["n_prefill_total"],
        decode_tokens=m["n_decode_total"],
        client_ms=[round(b["client_ms"], 1) for b in w["bodies"]],
        wave1_wall_s=w["wall_s"],
        window_tok_s=w["n_generated"] / w["wall_all_s"])


def _serve(engine, app, url, seed, dev, profile, mode):
    from llama_box_tpu_torch.server.engine import Engine, EngineConfig
    from llama_box_tpu_torch.server.metrics import Metrics
    counters = kernel_counters()
    tok = engine.tokenizer
    rng = np.random.default_rng(seed + 1)
    texts = [make_prompt(tok, rng, 500) for _ in range(3)]

    # warm-up (cuBLAS handles, the kernel libraries) through the text
    # route with raw token ids: it shares no prefix with the chat prompts
    # (they start with BOS), so no request below reuses its cache rows
    st, _, _ = http(url + "/v1/completions", dict(
        prompt=list(range(300, 332)), max_tokens=8, temperature=0))
    assert st == 200
    # -- the main path: counts from 0 -----------------------------------
    engine.metrics = Metrics()
    for fn in counters.values():
        fn.launches = 0
    wave = run_wave(url, texts, seed)
    launches = {k: fn.launches for k, fn in counters.items()}
    m = engine.metrics.snapshot()
    # -------------------------------------------------------------------
    path_kernels = PATHS[mode][4]
    for k, n in launches.items():
        if k in path_kernels:
            assert n > 0, f"{k} was never launched on the main path"
        else:
            assert n == 0, f"{k} launched on the {mode} path"
    assert engine.graphs.n_graphs > 0, "the server replayed no CUDA graph"
    log(f"  launches on the main path: {launches}")
    log(f"  CUDA graphs: {engine.graphs.n_graphs} captured, pool "
        f"{engine.graphs.pool_bytes / 2**20:.1f} MiB")
    e2e = wave_metrics(wave, m)
    if mode != "bf16":              # bf16: phase 10, after phase 8
        e2e["embed"] = embed_path_check(engine, url, seed, mode)
    e2e.update(graphs=engine.graphs.n_graphs,
               graph_pool_mib=engine.graphs.pool_bytes / 2**20)

    log(f"== phase {PATHS[mode][0]}b: in process")
    if mode == "w8a8":
        e2e.update(w8a8_reference_check(engine, dev))
    elif mode == "q4":
        e2e.update(q4_reference_check(engine, dev))
    else:
        e32, e16 = reference_check(engine, dev)
        e2e.update(ref_f32_max_abs_err=e32, ref_bf16_max_abs_err=e16)
    prompts = [tok.encode(t) for t in texts] + [tok.encode(texts[0][::-1])]
    outs = {}
    for kv in ("bfloat16", "int8"):
        for k in (1, CHAIN):
            ecfg = EngineConfig(n_slots=N_SLOTS, n_ctx=N_CTX,
                                n_ubatch=N_UBATCH, kv_dtype=kv,
                                decode_chain=k)
            outs[kv, k] = greedy_run(Engine, ecfg, engine.cfg, engine.params,
                                     tok, prompts, 32, dev)
        same = outs[kv, 1] == outs[kv, CHAIN]
        log(f"  greedy K=1 vs K={CHAIN}, {kv} cache: "
            f"{'identical' if same else 'DIFFERENT'}")
        assert same, f"K=1 and K={CHAIN} greedy outputs differ ({kv} cache)"
    e2e["modes"] = modes_phase(engine, app, seed, texts, wave, mode)
    e2e["host"] = host_phase(engine, app, seed, mode)
    if mode != "bf16":              # bf16: phase 8, after phase 6
        e2e["spec"] = spec_path_phase(engine, app, seed, mode)
    if profile:
        e2e["profile"] = {
            label: profile_phase(Engine, EngineConfig, engine, tok, prompts,
                                 dev, mode, graphs, pipe)
            for label, (graphs, pipe) in MODES.items()}
    return launches, e2e


# phase c's modes: label -> (cuda_graphs, pipeline_chain); the first is
# the default the main path serves with; "eager" runs strictly
# alternating chains too (an eager engine's host launches a speculated
# chain's every kernel before it can wait for the first tokens)
MODES = {"graphs": (True, True), "eager": (False, False),
         "lockstep": (True, False)}
REPS = 3    # measured waves a mode
# the arrival probe: rounds a mode, requests a round, the background's
# tokens a chat (fewer where the engine runs eagerly; doubled when
# TinyLlama went from 8 to 4 layers, so the background lasts as long)
PROBE_ROUNDS, PROBES = 2, 6
PROBE_BG_TOKENS = {True: 768, False: 192}


def arrival_probe(url, bg_texts, probe_texts, bg_tokens, delays):
    """Requests that arrive while others decode. Three greedy chats of
    bg_texts (bg_tokens each) and, on a thread of their own from 0.3 s
    on, one-token chats of probe_texts one after another, the i-th after
    a pause of delays[i] s (so they land at other points of a chain).
    A probe's client ms is its time to its one token as its user sees
    it: its wait in the queue, the chains ahead of its prefill on the
    stream, and the prefill. Returns the ms of the probes that ended
    before the first background chat did, the background's tokens over
    its wall, and every text."""
    def chat(text, n):
        st, body, ms = http(url + "/v1/chat/completions", dict(
            messages=[{"role": "user", "content": text}], max_tokens=n,
            temperature=0, ignore_eos=True))
        assert st == 200, st
        b = json.loads(body)
        assert b["usage"]["completion_tokens"] == n, b["usage"]
        return b["choices"][0]["message"]["content"], ms, time.perf_counter()

    def probes():
        time.sleep(0.3)
        out = []
        for text, d in zip(probe_texts, delays):
            time.sleep(d)
            out.append(chat(text, 1))
        return out
    res = concurrently([lambda t=t: chat(t, bg_tokens) for t in bg_texts]
                       + [probes])
    bg, pr = res[:-1], res[-1]
    t_bg_end = min(t for _, _, t in bg)
    return dict(ms=[ms for _, ms, t in pr if t < t_bg_end],
                bg_tok_s=len(bg) * bg_tokens / max(ms for _, ms, _ in bg)
                * 1e3,
                texts=[c for c, _, _ in bg + pr])


def modes_phase(engine, app, seed, texts, main_wave, mode):
    """The same waves on three fresh engines of the same model: graphs on
    and chains pipelined (the default), cuda_graphs=False, and graphs on
    with pipeline_chain=False; each served in process by the same HTTP
    routes after two warm-up waves of other prompts of the same lengths (a
    key's first use runs eagerly and its second captures, so the measured
    waves replay graphs). Then REPS measured waves, the modes in turn and
    each rep starting with another mode: the main path's texts first,
    then new prompts of the same lengths. Every rep's greedy texts and
    seeded text must be identical in all modes, the first rep's to the
    main path's, and the default mode must have dispatched speculated
    chains. Each metric is the median over the reps. Then PROBE_ROUNDS
    rounds of arrival_probe, the modes in turn: the probes' texts and the
    background's identical in all modes, and the median of the probes'
    ms that landed mid-decode. Then the host's cost: a kernel entry's C
    call, a torch op, an eager decode step and a graph replay of a
    16-step chain."""
    import copy

    from llama_box_tpu_torch.server.engine import Engine
    from llama_box_tpu_torch.server.metrics import Metrics
    log(f"== phase {PATHS[mode][0]}c: graphs on and off, pipelined and "
        f"not, {REPS} waves in turn, in process")
    rng = np.random.default_rng(seed + 7)
    warm = [[make_prompt(engine.tokenizer, rng, 500) for _ in range(3)]
            for _ in range(2)]
    reps = [texts] + [[make_prompt(engine.tokenizer, rng, 500)
                       for _ in range(3)] for _ in range(REPS - 1)]
    engines, servers, urls, n0 = {}, [], {}, {}
    waves = {label: [] for label in MODES}
    try:
        for label, (graphs, pipe) in MODES.items():
            ecfg = dataclasses.replace(engine.ecfg, cuda_graphs=graphs,
                                       pipeline_chain=pipe)
            eng = engines[label] = Engine(engine.cfg, engine.params,
                                          engine.tokenizer, ecfg,
                                          device=str(engine.device))
            eng.start()
            app2 = copy.copy(app)
            app2.engine = eng
            srv = app2.make_server("127.0.0.1", 0)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            servers.append((srv, thread))
            urls[label] = f"http://127.0.0.1:{srv.server_address[1]}"
            for i, w_texts in enumerate(warm):
                run_wave(urls[label], w_texts, seed + 1 + i)
            n0[label] = eng.graphs.n_graphs
        order = list(MODES)
        for i, r_texts in enumerate(reps):
            r_seed = seed if i == 0 else seed + 100 + i
            for label in order[i % len(order):] + order[:i % len(order)]:
                eng = engines[label]
                eng.metrics = Metrics()
                w = run_wave(urls[label], r_texts, r_seed)
                m = eng.metrics.snapshot()
                waves[label].append(dict(
                    wave_metrics(w, m), spec_chains=m["n_spec_chains"],
                    spec_post_prefill=m["n_spec_post_prefill"],
                    texts={k: w[k] for k in ("greedy", "streamed",
                                             "sampled")}))
            want = main_wave if i == 0 else waves["graphs"][i]["texts"]
            for label in MODES:
                for k in ("greedy", "streamed", "sampled"):
                    assert waves[label][i]["texts"][k] == want[k], \
                        f"{label}, rep {i}: {k} text differs"
        captured = {label: engines[label].graphs.n_graphs - n0[label]
                    for label in MODES}
        probed = {label: [] for label in MODES}
        bg_rate = {label: [] for label in MODES}
        for i in range(PROBE_ROUNDS):
            bg = [make_prompt(engine.tokenizer, rng, 500) for _ in range(3)]
            pr = [make_prompt(engine.tokenizer, rng, 500)
                  for _ in range(PROBES)]
            delays = rng.uniform(0, 0.06, PROBES)
            texts_i = {}
            for label in order[i % len(order):] + order[:i % len(order)]:
                p = arrival_probe(urls[label], bg, pr,
                                  PROBE_BG_TOKENS[MODES[label][0]], delays)
                probed[label] += p["ms"]
                bg_rate[label].append(p["bg_tok_s"])
                texts_i[label] = p["texts"]
            for label in MODES:
                # the background's length depends on cuda_graphs
                same = MODES[label][0] == MODES["graphs"][0]
                n = 0 if same else 3
                parted = [(k, next(j for j, (x, y) in enumerate(zip(a, b))
                                   if x != y) if a[:len(b)] != b[:len(a)]
                           else min(len(a), len(b)))
                          for k, (a, b) in enumerate(
                              zip(texts_i[label], texts_i["graphs"]))
                          if k >= n and a != b]
                assert not parted, f"{label}, probe round {i}: texts " \
                    f"(index, first differing character) {parted} differ"
        res = {}
        for label in MODES:
            eng, ws = engines[label], waves[label]
            r = res[label] = {k: statistics.median(w[k] for w in ws)
                              for k in ("ttft_p50_ms", "prefill_tok_s",
                                        "decode_tok_s", "window_tok_s",
                                        "wave1_wall_s")}
            ms = probed[label]
            assert len(ms) >= PROBES, f"{label}: {len(ms)} probes landed " \
                "mid-decode"
            r.update(waves=[{k: v for k, v in w.items() if k != "texts"}
                            for w in ws],
                     graphs=eng.graphs.n_graphs,
                     captured_in_waves=captured[label],
                     graph_pool_mib=eng.graphs.pool_bytes / 2**20,
                     spec_chains=sum(w["spec_chains"] for w in ws),
                     spec_post_prefill=sum(w["spec_post_prefill"]
                                           for w in ws),
                     arrival_ttft_p50_ms=statistics.median(ms),
                     arrival_ttft_mean_ms=statistics.fmean(ms),
                     arrival_ttft_ms=ms,
                     arrival_bg_tok_s=statistics.median(bg_rate[label]))
            log(f"  {label:8s}: medians of {REPS}: TTFT p50 "
                f"{r['ttft_p50_ms']:.2f} ms, prefill "
                f"{r['prefill_tok_s']:.1f} tok/s, decode "
                f"{r['decode_tok_s']:.1f} tok/s, window "
                f"{r['window_tok_s']:.1f} tok/s, wave 1 "
                f"{r['wave1_wall_s']:.4f} s; {r['graphs']} graphs "
                f"({r['captured_in_waves']} captured in the measured waves), "
                f"pool {r['graph_pool_mib']:.1f} MiB, speculated chains "
                f"{r['spec_chains']} ({r['spec_post_prefill']} off a "
                "prefill)")
            for k in ("ttft_p50_ms", "prefill_tok_s", "decode_tok_s",
                      "window_tok_s"):
                log(f"    {k:<14s} " + " ".join(f"{w[k]:.2f}" for w in ws))
            log(f"    arrival mid-decode: {len(ms)} probes, client ms p50 "
                f"{r['arrival_ttft_p50_ms']:.2f}, mean "
                f"{r['arrival_ttft_mean_ms']:.2f}: "
                + " ".join(f"{x:.1f}" for x in ms)
                + "; background " + " ".join(f"{x:.1f}"
                                             for x in bg_rate[label])
                + " tok/s")
        assert res["graphs"]["graphs"] > 0 and res["eager"]["graphs"] == 0
        assert res["lockstep"]["graphs"] > 0
        assert res["graphs"]["spec_chains"] > 0, "no chain was speculated"
        assert res["lockstep"]["spec_chains"] == 0
        assert res["eager"]["spec_chains"] == 0
        log("  greedy texts and the seeded text identical with graphs on "
            "and off, pipelined and not, in every rep; probes' and "
            "background texts too")
        res["host"] = host_costs(engines["eager"], engines["graphs"])
    finally:
        for srv, thread in servers:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
        for eng in engines.values():
            eng.stop()
    return res


_CAPTURE_FAILS = """
import torch
from llama_box_tpu_torch.server.cuda_graph import GraphRunner
runner = GraphRunner(torch.device("cuda"))
x = torch.ones(4, device="cuda")
def fn():
    y = x * 2
    torch.cuda.synchronize()    # no capture can take a device synchronise
    return y
assert torch.equal(runner.run("k", fn), x * 2)     # the eager first use
try:
    runner.run("k", fn)
except RuntimeError as exc:
    assert runner.n_graphs == 0
    print("raised:", str(exc).splitlines()[0][:120])
else:
    raise SystemExit("a failed capture did not raise")
"""


def capture_failure_check() -> None:
    """A capture that fails raises out of the graph runner (no eager
    fallback), in a process of its own (a failed capture may leave the
    context unusable)."""
    r = subprocess.run([sys.executable, "-c", _CAPTURE_FAILS],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    log(f"  capture failure: {r.stdout.strip()} (rc {r.returncode})")
    assert r.returncode == 0, r.stderr[-2000:]


def host_costs(eager, graphs) -> dict:
    """Host microseconds (the card idle, no sync inside the timed loop):
    one C call of each kernel entry a decode step makes (its recorded
    arguments, ctypes conversion included), one small torch op, one eager
    decode step of 4 slots (the whole enqueue) and one replay of the
    16-step chain's graph. Each the median of 5 runs of 50 calls (steps:
    of 5)."""
    from llama_box_tpu_torch.ops import _kernels
    S = len(eager.slots)

    def stage(eng):
        h = eng._dec_in.host()
        h[:S], h[S:2 * S], h[2 * S:] = 400, 600, 1
        eng._dec_in.push()

    def per_call(fn, n=50):
        out = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            out.append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
        return statistics.median(out)

    stage(eager)
    calls, orig = {}, _kernels.call

    def spy(lib, fn, *args):
        calls.setdefault(fn, (lib, fn, args))
        return orig(lib, fn, *args)
    _kernels.call = spy
    try:
        eager._decode_program(1, samp_extras=False, samp_kcap=64)
    finally:
        _kernels.call = orig
    torch.cuda.synchronize()
    out = {f"call_us.{fn}": per_call(lambda a=a: orig(*a[:2], *a[2]))
           for fn, a in calls.items()}
    x = torch.ones(64, device=eager.device)
    out["torch_op_us"] = per_call(lambda: x.add(1))
    out["eager_step_ms"] = per_call(lambda: eager._decode_program(
        1, samp_extras=False, samp_kcap=64), n=5) / 1e3
    stage(graphs)
    key = ("decode", CHAIN, False, 64)
    for _ in range(2):
        graphs.graphs.run(key, lambda: graphs._decode_program(
            CHAIN, samp_extras=False, samp_kcap=64))
    n0 = graphs.graphs.n_graphs
    out["replay_chain16_us"] = per_call(lambda: graphs.graphs.run(
        key, lambda: graphs._decode_program(CHAIN, samp_extras=False,
                                            samp_kcap=64)), n=5)
    assert graphs.graphs.n_graphs == n0
    log("  host: " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


# the port's own kernels in a profile (names as nvcc gives them)
PORT_KERNELS = ("flash_prefill", "flash_decode", "grouped_gemm", "w8a8_gemm",
                "quant_rows", "norm_qmm", "tail_phase")


def profile_phase(Engine, EngineConfig, engine, tok, prompts, dev, label,
                  graphs=True, pipeline=True):
    """--profile: torch.profiler over 4 greedy requests (one batched
    prefill, then 48 tokens each in chains of 16), bf16 cache, graphs on
    or off, chains pipelined or not: device time by kernel and the
    device's busy share of the wall
    time; then over 4 other prompts of the same lengths with one token
    each, the prefill pass alone (its device ms by kernel; decode is the
    first profile less it). One engine serves two warm-ups of the same
    shapes first (the prompts reversed, then rotated by two: no shared
    prefix), so every graph is captured before the profiles."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    mode = ("graphs" if graphs else "eager") + (
        "" if pipeline else ", pipeline_chain=False")
    log("== profile: 4 x (500-token prompt + 48 tokens), bf16 cache, K=16, "
        f"{label} weights, {mode}")
    ecfg = EngineConfig(n_slots=N_SLOTS, n_ctx=N_CTX, n_ubatch=N_UBATCH,
                        kv_dtype="bfloat16", decode_chain=CHAIN,
                        cuda_graphs=graphs, pipeline_chain=pipeline)
    eng = Engine(engine.cfg, engine.params, tok, ecfg, device=str(dev))
    eng.start()
    try:
        for warm in ([p[::-1] for p in prompts],
                     [p[2:] + p[:2] for p in prompts]):
            greedy_on(eng, tok, warm, 48)
            greedy_on(eng, tok, [p[3:] + p[:3] for p in warm], 1)
        n0 = eng.graphs.n_graphs
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with tprofile(activities=acts) as prof:
            t0 = time.perf_counter()
            greedy_on(eng, tok, prompts, 48)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ka = prof.key_averages()
        # the prefill pass apart: four other prompts (one token each: one
        # batched prefill pass, no decode step); decode is the rest
        with tprofile(activities=acts) as prof2:
            greedy_on(eng, tok, [p[1:] + p[:1] for p in prompts], 1)
            torch.cuda.synchronize()
        captured = eng.graphs.n_graphs - n0
    finally:
        eng.stop()
    dev_us = sum(e.self_device_time_total for e in ka)
    n_launch = sum(e.count for e in ka if e.self_device_time_total > 0)
    per_layer = n_launch / (48 * engine.cfg.n_layers)
    log(f"  wall {wall_ms:.1f} ms, device busy {dev_us / 1e3:.1f} ms "
        f"({dev_us / 1e3 / wall_ms:.3f} of wall), ops with device time: "
        f"{n_launch} (about {per_layer:.1f} per layer per decode step); "
        f"graphs captured inside the profiles: {captured}")
    rows = sorted(ka, key=lambda e: -e.self_device_time_total)[:20]
    for e in rows:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:7d}x  "
            f"{e.key[:90]}")
    ours = {e.key[:100]: (e.self_device_time_total / 1e3, e.count)
            for e in ka if e.self_device_time_total > 0
            and any(t in e.key for t in PORT_KERNELS)}
    for k, (ms, n) in sorted(ours.items(), key=lambda kv: -kv[1][0]):
        log(f"  port kernel {ms:9.2f} ms  {n:7d}x  {k[:90]}")
    pre = sorted(((e.key[:100], e.self_device_time_total / 1e3, e.count)
                  for e in prof2.key_averages()
                  if e.self_device_time_total > 0), key=lambda r: -r[1])
    pre_ms = sum(r[1] for r in pre)
    log(f"  prefill pass alone (max_tokens 1): device {pre_ms:.2f} ms, "
        f"{sum(r[2] for r in pre)} ops; decode (the rest) "
        f"{dev_us / 1e3 - pre_ms:.2f} ms")
    for k, ms, n in pre[:15]:
        log(f"  prefill {ms:9.2f} ms  {n:7d}x  {k[:90]}")
    return dict(wall_ms=wall_ms, device_busy_ms=dev_us / 1e3,
                busy_share=dev_us / 1e3 / wall_ms, device_ops=n_launch,
                ops_per_layer_step=per_layer, captured_in_profile=captured,
                top=[(e.key[:100], e.self_device_time_total / 1e3, e.count)
                     for e in rows], port_kernels=ours,
                prefill_device_ms=pre_ms, prefill_ops=sum(r[2] for r in pre),
                decode_device_ms=dev_us / 1e3 - pre_ms, prefill_top=pre[:20])


# ---------------------------------------------------------------------------
# phase 6: the in-place KV-cache edits (context shift, cross-slot prefix
# copy) on the bf16 path's model


SHIFT_CTX, SHIFT_TOKENS = 2048, 700     # -np 4: slot capacity 512
SHIFT_PROMPTS = (200, 250, 300, 350)
# the shift wave's modes: label -> EngineConfig fields; the first serves
# with every graph captured, under set_sync_debug_mode("error")
SHIFT_MODES = {"graphs": {}, "lockstep": dict(pipeline_chain=False),
               "eager": dict(cuda_graphs=False, pipeline_chain=False),
               "k1": dict(decode_chain=1)}
SHARE_PREFIX, SHARE_WARM, SHARE_REPS, SHARE_TOKENS = 1500, 2, 5, 8
# a donor is replaced before a chat once fewer tokens than this are left
# to it (a chat and its three one-token neighbours wait behind at most
# two chains of 16 and 4 steps each and decode 8 tokens beside it)
DONOR_MARGIN = 120
# a step whose top-2 log-prob margin is within this may pick either token
# (twice the bf16 tolerance, as tests/test_torch_graph_ready.py compares)
NEAR_TIE = 2 * BF16_ATOL


def _leaves(kv) -> list:
    return [x for x in kv if x is not None]


def wait_final(task, timeout=600):
    """A task's final state (its error raised)."""
    while True:
        kind, payload = task.result_q.get(timeout=timeout)
        if kind == "error":
            raise payload
        if kind == "final":
            return payload


def _stage_prefill(eng, chunks, T):
    S = len(eng.slots)
    h = eng._pre_in.host()
    h[:S * (3 + T)] = 0
    tok = h[3 * S:S * (3 + T)].reshape(S, T)
    for b, (p, ids) in chunks.items():
        tok[b, :len(ids)] = ids
        h[b], h[S + b], h[2 * S + b] = p, len(ids), 1
    eng._pre_in.push(S * (3 + T))


def _stage_decode(eng, tokens, pos):
    S = len(eng.slots)
    h = eng._dec_in.host()
    h[:] = 0
    h[S:2 * S] = eng.slot_ctx
    for b, (t, p) in enumerate(zip(tokens, pos)):
        if t is not None:
            h[b], h[S + b], h[2 * S + b] = t, p, 1
    eng._dec_in.push()


def warm_every_key(eng) -> None:
    """Run every program key a greedy ignore_eos wave can meet twice (its
    eager first use, then its capture), so the wave only replays."""
    S = len(eng.slots)
    for T in eng.buckets:
        for _ in range(2):
            _stage_prefill(eng, {0: (0, [400] * T)}, T)
            eng._refresh_arrs()
            eng.graphs.run(("prefill", T),
                           lambda T=T: eng._prefill_program(T))
    K = 1
    while K <= eng.ecfg.decode_chain:
        for _ in range(2):
            _stage_decode(eng, [400] + [None] * (S - 1), [0] * S)
            eng.graphs.run(("decode", K, True, 0),
                           lambda K=K: eng._decode_program(K))
        K *= 2
    torch.cuda.synchronize()


def shift_reference(probe, quant) -> dict:
    """One shift held against a float64 host reference of it, built from
    the slot's cache read just before it (the engine's f32 delta tables,
    the half-split rotation the engine applies): bf16 keys within one
    bf16 ulp of the rounded reference, except where the rotation's two
    terms cancel below the f32 rounding of the terms (those within one
    ulp beside that rounding; counted), and every other row and value
    bit-equal; int8 codes within 1 and each scale one of the bf16
    roundings of the reference scale x (1 -+ 1e-6) (the two differ only
    where f32 arithmetic may round either way; counted)."""
    pre = [x.cpu().double().numpy() for x in probe["pre"]]
    post = [x.cpu() for x in probe["post"]]
    nk, nd = probe["n_keep"], probe["n_discard"]
    C = pre[0].shape[1]
    idx = np.arange(C)
    src = np.where(idx < nk, idx, np.minimum(idx + nd, C - 1))
    k = pre[0][:, src]
    if quant:
        k = k * pre[2][:, src][..., None]
    c = probe["dcos"][nd].double().cpu().numpy()
    s = probe["dsin"][nd].double().cpu().numpy()
    h = c.shape[-1]
    x0, x1 = k[..., :h], k[..., h:2 * h]
    rot = np.concatenate([x0 * c + x1 * s, x1 * c - x0 * s, k[..., 2 * h:]],
                         axis=-1)
    # what the f32 rotation may miss by: its two products and their sum
    # each round once (where they cancel, below one bf16 ulp of the sum)
    f32_err = 2.0 ** -22 * np.concatenate(
        [np.abs(x0 * c) + np.abs(x1 * s), np.abs(x1 * c) + np.abs(x0 * s),
         np.zeros_like(k[..., 2 * h:])], axis=-1)
    moved = (idx >= nk)[None, :, None, None]
    kref = np.where(moved, rot, k)
    ok_v = np.array_equal(post[1].double().numpy(), pre[1][:, src])
    out = dict(n_keep=nk, n_discard=nd, slot=probe["slot"], v_equal=ok_v)
    if quant:
        ok_v &= np.array_equal(post[3].double().numpy(), pre[3][:, src])
        amax = np.abs(kref).max(axis=-1)
        sc = np.maximum(amax, 1e-6) / 127.0
        lo = torch.from_numpy(sc * (1 - 1e-6)).to(torch.bfloat16).double()
        hi = torch.from_numpy(sc * (1 + 1e-6)).to(torch.bfloat16).double()
        got_s = post[2].double()
        scale_ok = bool(((got_s == lo) | (got_s == hi)).all())
        codes = np.clip(np.round(kref / got_s.numpy()[..., None]), -127, 127)
        diff = np.abs(post[0].double().numpy() - codes)
        out.update(codes_max_diff=float(diff.max()),
                   codes_equal_share=float((diff == 0).mean()),
                   scales_ok=scale_ok,
                   scales_ambiguous=int((lo != hi).sum()), v_equal=ok_v)
        ok = ok_v and scale_ok and diff.max() <= 1
    else:
        ref16 = torch.from_numpy(kref).to(torch.bfloat16).double().numpy()
        got = post[0].double().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref16),
                                                  2.0 ** -126))) - 7)
        diff = np.abs(got - ref16)
        # within one bf16 ulp, or (where the rotation cancels) within one
        # ulp beside the f32 rounding of its terms
        over = diff > ulp
        bad = diff > ulp + np.where(moved, f32_err, 0.0)
        kept_ok = np.array_equal(got[:, :nk], pre[0][:, :nk])
        out.update(max_ulps=float((diff / ulp).max()),
                   equal_share=float((diff == 0).mean()),
                   beyond_one_ulp=int(over.sum()),
                   beyond_f32_bound=int(bad.sum()), kept_equal=kept_ok)
        ok = ok_v and kept_ok and not bad.any()
    log(f"  shift vs float64 reference (slot {probe['slot']}, keep {nk}, "
        f"discard {nd}): " + json.dumps(out))
    assert ok, out
    return out


def next_step_check(engine, probe, dev, quant, ref) -> dict:
    """The next step's logits off the shifted slot (its next token at its
    new position, a one-slot copy of the cache just after the shift): the
    card with the engine's weights and cache type, and the card in f32,
    against an f32 forward on the CPU, under reference_check's gates."""
    from llama_box_tpu_torch.models import llama
    cfg = engine.cfg
    post = probe["post"]
    C = post[0].shape[1]

    def one_slot(device, f32):
        if not f32:
            return llama.KVCache(*[x[:, None].to(device).clone()
                                   for x in post])
        k, v = post[0].float(), post[1].float()
        if quant:
            k = k * post[2].float()[..., None]
            v = v * post[3].float()[..., None]
        return llama.KVCache(k[:, None].to(device).contiguous(),
                             v[:, None].to(device).contiguous())

    tok = torch.tensor([[probe["token"]]])
    pos = np.array([[probe["pos"]]])

    def logits(params, device, f32):
        cos, sin = llama.make_rope(cfg, C, device=device)
        lg, _ = llama.forward_impl(params, cfg, tok, pos,
                                   one_slot(device, f32), cos, sin)
        return lg[:, 0].float().cpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    want = logits(ref["cpu32"], "cpu", True)
    got32 = logits(ref["card32"], dev, True)
    got = logits(engine.params, dev, False)
    assert torch.isfinite(got).all() and torch.isfinite(got32).all()
    scale = float(want.abs().max())
    e32 = float((got32 - want).abs().max())
    cos_ = _cosine(got, want)
    log(f"  next step off the shifted cache: f32 card vs f32 CPU "
        f"max_abs_err {e32:.3e} (tol {1e-3 * max(1.0, scale):.3e}); "
        f"{'int8' if quant else 'bf16'} cache card vs f32 CPU min cosine "
        f"{cos_:.6f} (tol 0.99)")
    assert e32 <= 1e-3 * max(1.0, scale), e32
    assert cos_ >= 0.99, cos_
    return dict(next_f32_max_abs_err=e32, next_min_cos=cos_)


def shift_phase(dev, seed, engine, kv_dtype, flush, ref) -> dict:
    """4 concurrent greedy ignore_eos requests (prompts of 200 to 350
    tokens, 700 tokens each) on -np 4 -c 2048: each slot (capacity 512)
    shifts 128 rows at a time, at its own steps. The same texts, ends and
    shift steps in every mode of SHIFT_MODES; no cache leaf moves; the
    first mode runs with every graph captured under
    set_sync_debug_mode("error"); the lockstep mode's first shift is held
    against shift_reference and next_step_check. Then the device ms of
    one shift beside its bytes bound."""
    from llama_box_tpu_torch.models import llama
    from llama_box_tpu_torch.sampling import SamplerParams
    from llama_box_tpu_torch.server.engine import Engine
    from llama_box_tpu_torch.server.task import CompletionsTask
    quant = kv_dtype == "int8"
    tag = "int8" if quant else "bf16"
    log(f"== phase 6, {tag} cache: context shift, -np 4 -c {SHIFT_CTX}, 4 x "
        f"{SHIFT_TOKENS} greedy tokens")
    tok = engine.tokenizer
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(300, V, n).tolist() for n in SHIFT_PROMPTS]
    base = dataclasses.replace(engine.ecfg, n_slots=4, n_ctx=SHIFT_CTX,
                               kv_dtype=kv_dtype)
    counters = kernel_counters()
    res, texts, steps, probe = {}, {}, {}, {}
    for label, kw in SHIFT_MODES.items():
        eng = Engine(engine.cfg, engine.params, tok,
                     dataclasses.replace(base, **kw), device=str(dev))
        ptrs = [x.data_ptr() for x in _leaves(eng.kv)]
        shifts, shift = [], eng._context_shift

        def spy(s, shifts=shifts, shift=shift, eng=eng, label=label):
            shifts.append((id(s.task), len(s.task.generated), s.pos))
            first = label == "lockstep" and "pre" not in probe
            if first:
                probe.update(slot=s.idx, pre=[x[:, s.idx].clone()
                                              for x in _leaves(eng.kv)],
                             dcos=eng.delta_cos, dsin=eng.delta_sin,
                             n_keep=max(0, min(s.task.n_keep, s.pos - 2)),
                             pos0=s.pos)
            shift(s)
            if first:
                probe.update(post=[x[:, s.idx].clone()
                                   for x in _leaves(eng.kv)],
                             n_discard=probe["pos0"] - s.pos, pos=s.pos,
                             token=s.next_token)
        eng._context_shift = spy
        if label == "graphs":
            warm_every_key(eng)
        n_graphs = eng.graphs.n_graphs
        eng.start()
        tasks = [CompletionsTask(p, SamplerParams(temp=0.0, ignore_eos=True),
                                 tokenizer=tok, max_tokens=SHIFT_TOKENS)
                 for p in prompts]
        t0 = time.perf_counter()
        try:
            if label == "graphs":
                for fn in counters.values():
                    fn.launches = 0
                torch.cuda.set_sync_debug_mode("error")
            try:
                for t in tasks:
                    eng.submit(t)
                finals = [wait_final(t) for t in tasks]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            wall = time.perf_counter() - t0
            launched = {k: fn.launches for k, fn in counters.items()}
            captured = eng.graphs.n_graphs - n_graphs
        finally:
            eng.stop()
        assert [x.data_ptr() for x in _leaves(eng.kv)] == ptrs, \
            f"{label}: a cache leaf moved"
        order = {id(t): i for i, t in enumerate(tasks)}
        steps[label] = [[n for tid, n, _ in shifts if order[tid] == i]
                        for i in range(len(tasks))]
        texts[label] = [list(f.generated) for f in finals]
        for f, st in zip(finals, steps[label]):
            assert f.finish_reason == "length", (label, f.finish_reason)
            assert len(f.generated) == SHIFT_TOKENS and f.n_shifted >= 2, \
                (label, len(f.generated), f.n_shifted)
            assert len(st) == f.n_shifted
        assert all(pos == eng.slot_ctx for _, _, pos in shifts), label
        res[label] = dict(wall_s=wall, shifts=[f.n_shifted for f in finals],
                          graphs=eng.graphs.n_graphs)
        if label == "graphs":
            assert captured == 0, "a graph was captured in the checked wave"
            assert launched["flash_decode"] > 0
            res[label]["launches"] = launched
        log(f"  {label:8s}: {wall:.2f} s wall, shifts "
            f"{res[label]['shifts']}, first at generated tokens "
            f"{[st[0] for st in steps[label]]}, {eng.graphs.n_graphs} graphs"
            + (", every graph captured before the wave, which ran under "
               "set_sync_debug_mode('error')" if label == "graphs" else ""))
    for label in SHIFT_MODES:
        for i, (x, y) in enumerate(zip(texts[label], texts["graphs"])):
            j = next((k for k, (p, q) in enumerate(zip(x, y)) if p != q),
                     None)
            assert j is None, (f"{label}: request {i}'s text differs from "
                               f"token {j} on (its shifts at generated "
                               f"tokens {steps['graphs'][i]})")
        assert steps[label] == steps["graphs"], f"{label}: shifts differ"
    assert len({st[0] for st in steps["graphs"]}) == len(prompts), \
        "two slots shifted at the same step"
    log("  texts, ends and shift steps identical in every mode; no cache "
        "leaf moved")
    res["reference"] = shift_reference(probe, quant)
    res["reference"].update(next_step_check(engine, probe, dev, quant, ref))

    # the device time of one shift (slot 1, n_keep 0, n_discard 128)
    kv = llama.init_kv_cache(engine.cfg, 4, SHIFT_CTX // 4, _KV_TORCH[tag],
                             dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    for x in _leaves(kv):
        if x.dtype == torch.int8:
            x.copy_(torch.randint(-127, 128, x.shape, generator=g,
                                  device=dev))
        else:
            x.copy_(torch.rand(x.shape, generator=g, device=dev) * 0.05)
    dcos, dsin = llama.make_delta_rope(engine.cfg, SHIFT_CTX // 4, dev)
    nd = (SHIFT_CTX // 4) // 4
    ms = device_ms(lambda: llama.shift_kv(kv, 1, 0, nd, dcos, dsin,
                                          engine.cfg.rope_mode), flush)
    nbytes = 2 * sum(x[:, 1].numel() * x.element_size() for x in _leaves(kv))
    b_ms, b_by = bound_ms(nbytes, 0)
    res["shift_ms"], res["shift_bound_ms"] = ms, b_ms
    res["shift_mbytes"] = nbytes / 1e6
    log(f"  one shift (L {engine.cfg.n_layers}, C {SHIFT_CTX // 4}, "
        f"discard {nd}): {ms:.5f} ms device (median of 15, cold L2), bound "
        f"{b_ms:.5f} ms ({b_by}: {nbytes / 1e6:.2f} MB read and written)")
    return res


_KV_TORCH = {"bf16": torch.bfloat16, "int8": torch.int8}


def _margins(body) -> list:
    """Each generated token's top-2 log-prob margin and its text."""
    out = []
    for e in body["choices"][0]["logprobs"]["content"]:
        lps = sorted((t["logprob"] for t in e["top_logprobs"]), reverse=True)
        out.append((e["token"], lps[0] - lps[1]))
    return out


def copy_phase(dev, seed, engine, app, kv_dtype, flush) -> dict:
    """A chat with a 1500-token shared prefix decodes (the donor) while
    other chats with that prefix arrive, one at a time, on the served
    engine's configuration (-np 4 -c 8192): before each, three one-token
    chats of other prompts take the idle slots, so no slot but the
    donor's holds the prefix. With --prompt-cache-share-min 32 (the
    default) each takes the donor's rows by one copy (cached_tokens
    >= 1499; the copied rows bit-equal to the donor's in the warm-ups);
    with -1 each recomputes them. Greedy texts equal both ways up to the
    first near tie; TTFT p50 of SHARE_REPS measured chats each way (after
    SHARE_WARM that capture the graphs); then the device ms of one copy
    of 1500 rows beside its bytes bound."""
    import copy as copy_mod

    from llama_box_tpu_torch.models import llama
    from llama_box_tpu_torch.server import engine as engine_mod
    from llama_box_tpu_torch.server.engine import Engine
    tag = "int8" if kv_dtype == "int8" else "bf16"
    log(f"== phase 6, {tag} cache: cross-slot prefix copy, -np {N_SLOTS} -c "
        f"{N_CTX}, a {SHARE_PREFIX}-token shared prefix")
    tok = engine.tokenizer
    rng = np.random.default_rng(seed + 13)
    shared = make_prompt(tok, rng, SHARE_PREFIX + 32)
    donor_text = shared + " " + make_prompt(tok, rng, 60)
    n = SHARE_WARM + SHARE_REPS
    tails = [make_prompt(tok, rng, 40) for _ in range(n)]
    scrubs = [[make_prompt(tok, rng, 60) for _ in range(3)]
              for _ in range(n)]
    slot_ctx = N_CTX // N_SLOTS
    counters = kernel_counters()
    # the donor decodes to just short of its capacity (a shift would drop
    # the shared rows)
    donor_tokens = slot_ctx - len(tok.encode(donor_text)) - 32
    copies, checked = [], []
    orig = engine_mod.copy_kv_prefix

    def spy(kv, src, dst, n_rows):
        out = orig(kv, src, dst, n_rows)
        copies.append(n_rows)
        if len(copies) <= SHARE_WARM:      # the warm-ups: a read-back
            checked.append(all(torch.equal(x[:, dst, :n_rows],
                                           x[:, src, :n_rows])
                               for x in _leaves(kv)))
        return out

    def chat(url, text, n_tok, **kw):
        st, body, ms = http(url + "/v1/chat/completions", dict(
            messages=[{"role": "user", "content": text}], max_tokens=n_tok,
            temperature=0, ignore_eos=True, **kw))
        assert st == 200, st
        return json.loads(body), ms

    res = {}
    for label, share_min in (("copy", 32), ("recompute", -1)):
        ecfg = dataclasses.replace(engine.ecfg, kv_dtype=kv_dtype,
                                   cache_share_min=share_min)
        eng = Engine(engine.cfg, engine.params, tok, ecfg, device=str(dev))
        eng.start()
        app2 = copy_mod.copy(app)
        app2.engine = eng
        srv = app2.make_server("127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        donors, errs, reps = [], [], []
        engine_mod.copy_kv_prefix = spy
        del copies[:], checked[:]
        for fn in counters.values():
            fn.launches = 0

        def donor_left():
            """The donor's tokens still to come (0: none decoding)."""
            for s in eng.slots:
                t = s.task
                if s.state == "decode" and t is not None \
                        and s.pos >= SHARE_PREFIX:
                    return t.max_tokens - len(t.generated)
            return 0

        def donor():
            try:
                chat(url, donor_text, donor_tokens)
            except Exception as exc:  # noqa: BLE001 — raised below
                errs.append(exc)
        try:
            for i in range(n):
                # a donor decoding the shared prefix, with enough tokens
                # left for this chat (else a new one, once the last has
                # ended: it takes its own cached rows)
                if donor_left() < DONOR_MARGIN:
                    for d in donors:
                        d.join(timeout=300)
                    d = threading.Thread(target=donor, daemon=True)
                    d.start()
                    donors.append(d)
                    t_end = time.perf_counter() + 120
                    while donor_left() < DONOR_MARGIN:
                        assert not errs and time.perf_counter() < t_end, \
                            f"no donor decodes: {errs}"
                        time.sleep(0.002)
                concurrently([lambda t=t: chat(url, t, 1)
                              for t in scrubs[i]])
                n_copies = len(copies)
                body, ms = chat(url, shared + " " + tails[i], SHARE_TOKENS,
                                logprobs=True, top_logprobs=2)
                u = body["usage"]
                reps.append(dict(
                    ttft_ms=u["time_to_first_token_ms"], client_ms=ms,
                    cached=u["prompt_tokens_details"]["cached_tokens"],
                    prompt=u["prompt_tokens"],
                    copies=len(copies) - n_copies,
                    donor_alive=donors[-1].is_alive(),
                    margins=_margins(body)))
            for d in donors:
                d.join(timeout=300)
                assert not d.is_alive(), "a donor did not end"
            assert not errs, errs
        finally:
            engine_mod.copy_kv_prefix = orig
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
            eng.stop()
        launched = {k: fn.launches for k, fn in counters.items()}
        assert launched["flash_prefill"] > 0 and launched["flash_decode"] > 0
        measured = reps[SHARE_WARM:]
        for r in reps:
            if label == "copy":
                assert r["cached"] >= SHARE_PREFIX - 1 and r["copies"] == 1, r
            else:
                assert r["cached"] < SHARE_PREFIX - 1 and r["copies"] == 0, r
        if label == "copy":
            assert checked and all(checked), "copied rows differ"
        res[label] = dict(
            ttft_p50_ms=statistics.median(r["ttft_ms"] for r in measured),
            ttft_ms=[r["ttft_ms"] for r in measured],
            client_ms=[round(r["client_ms"], 2) for r in measured],
            cached=[r["cached"] for r in reps],
            prompt_tokens=[r["prompt"] for r in reps], donors=len(donors),
            donor_alive=[r["donor_alive"] for r in reps], launches=launched)
        res[label, "margins"] = [r["margins"] for r in reps]
        log(f"  {label:9s}: TTFT p50 {res[label]['ttft_p50_ms']:.2f} ms "
            f"({SHARE_REPS} chats: "
            + " ".join(f"{x:.2f}" for x in res[label]["ttft_ms"])
            + f"), cached_tokens {res[label]['cached']}, prompt tokens "
            f"{res[label]['prompt_tokens']}, donors {len(donors)}")
    compared = []
    for a, b in zip(res.pop(("copy", "margins")),
                    res.pop(("recompute", "margins"))):
        j = next((i for i, ((_, ma), (_, mb)) in enumerate(zip(a, b))
                  if min(ma, mb) <= NEAR_TIE), len(a))
        assert [t for t, _ in a[:j]] == [t for t, _ in b[:j]], \
            "copy and recompute texts differ before a near tie"
        compared.append(j)
    res["tokens_compared"] = compared
    log(f"  copy and recompute texts identical up to the first near tie "
        f"(top-2 margin <= {NEAR_TIE}): tokens compared {compared} of "
        f"{SHARE_TOKENS} each; copied rows bit-equal to the donor's")

    # the device time of one copy of SHARE_PREFIX rows, slot 0 into 1
    kv = llama.init_kv_cache(engine.cfg, N_SLOTS, slot_ctx, _KV_TORCH[tag],
                             dev)
    ms = device_ms(lambda: llama.copy_kv_prefix(kv, 0, 1, SHARE_PREFIX),
                   flush)
    nbytes = 2 * sum(x[:, 0, :SHARE_PREFIX].numel() * x.element_size()
                     for x in _leaves(kv))
    b_ms, b_by = bound_ms(nbytes, 0)
    res.update(copy_ms=ms, copy_bound_ms=b_ms, copy_mbytes=nbytes / 1e6)
    log(f"  one copy of {SHARE_PREFIX} rows: {ms:.5f} ms device (median of "
        f"15, cold L2), bound {b_ms:.5f} ms ({b_by}: {nbytes / 1e6:.2f} MB "
        "read and written)")
    return res


def kv_edit_phase(dev, seed, engine, app) -> dict:
    """Phase 6 on the bf16 path's model (its weights, as served), with a
    bf16 and an int8 cache."""
    ref = dict(cpu32=_moved(engine.params, "cpu", torch.float32),
               card32=_moved(engine.params, dev, torch.float32))
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for kv_dtype in ("bfloat16", "int8"):
        tag = "int8" if kv_dtype == "int8" else "bf16"
        out[tag] = dict(shift=shift_phase(dev, seed, engine, kv_dtype,
                                          flush, ref),
                        copy=copy_phase(dev, seed, engine, app, kv_dtype,
                                        flush))
    return out


# ---------------------------------------------------------------------------
# phase 7: host-controlled decode (grammar, JSON schema, tools, mirostat,
# DRY, the rate header) on each served path

HOST_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"},
    "n": {"type": "integer", "enum": [1, 2, 3, 5, 8, 13]},
    "mode": {"enum": ["fast", "slow", "auto"]}},
    "required": ["ok", "n", "mode"]}
HOST_GBNF = 'root ::= ("yes" | "no") " " [a-z]{2,8} (" " [a-z]{2,8}){0,3} "."'
HOST_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "parameters": {
        "type": "object", "properties": {"city": {"type": "string"}},
        "required": ["city"]}}}]
HOST_TOOL_GBNF = ('root ::= "<tool_call>{\\"name\\": \\"get_weather\\", '
                  '\\"arguments\\": {\\"city\\": \\"" [a-z]{2,10} '
                  '"\\"}}</tool_call>"')
# the tool call's literal is up to 87 characters, a token each at worst
HOST_TOKENS, HOST_TOOL_TOKENS, HOST_PROMPT = 64, 128, 160
RATE_TPS, RATE_TOKENS, RATE_FROM = 20, 100, 30
HOST_MODES = {"graphs": {}, "eager": dict(cuda_graphs=False,
                                          pipeline_chain=False)}


def warm_host_keys(eng) -> None:
    """Every program key phase 7's traffic can meet, run twice (its eager
    first use, then its capture): the prefill buckets, the decode chains
    of plain slots, and the one-token pass of all three sampler
    variants."""
    S = len(eng.slots)
    for T in eng.buckets:
        for _ in range(2):
            _stage_prefill(eng, {0: (0, [400] * T)}, T)
            eng._refresh_arrs()
            eng.graphs.run(("prefill", T),
                           lambda T=T: eng._prefill_program(T))
    K = 1
    while K <= eng.ecfg.decode_chain:
        for _ in range(2):
            _stage_decode(eng, [400] + [None] * (S - 1), [0] * S)
            eng.graphs.run(("decode", K, False, 64),
                           lambda K=K: eng._decode_program(
                               K, samp_extras=False, samp_kcap=64))
        K *= 2
    for extras, kcap in ((True, 0), (False, 64), (False, 0)):
        kw = dict(samp_extras=extras, samp_kcap=kcap) if kcap else \
            dict(samp_extras=extras)
        for _ in range(2):
            eng._stage_one([400, 401] + [None] * (S - 2), [0] * S, [0])
            eng.graphs.run(("one", extras, kcap),
                           lambda kw=kw: eng._one_token_program(**kw))
    torch.cuda.synchronize()


def _prom(text) -> dict:
    """Prometheus text -> {name: value}; every line must parse."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            assert ln.split()[2].startswith("llamabox:"), ln
            continue
        name, val = ln.split()
        assert name.startswith("llamabox:"), ln
        out[name] = float(val)
    return out


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs \
        else float("nan")


def host_wave(url, texts, seed):
    """Four concurrent host-controlled requests: a greedy JSON-schema chat,
    a greedy GBNF completion, a seeded mirostat chat and a greedy DRY chat
    with tools and a grammar forcing one tool call. Returns their bodies."""
    def chat(text, **kw):
        body = dict(messages=[{"role": "user", "content": text}],
                    max_tokens=HOST_TOKENS)
        body.update(kw)
        return lambda: http(url + "/v1/chat/completions", body)
    fns = [
        chat(texts[0], temperature=0, response_format={
            "type": "json_schema",
            "json_schema": {"name": "probe", "schema": HOST_SCHEMA}}),
        lambda: http(url + "/v1/completions", dict(
            prompt=texts[1], max_tokens=HOST_TOKENS, temperature=0,
            grammar=HOST_GBNF)),
        chat(texts[2], temperature=0.8, seed=seed, mirostat=2,
             ignore_eos=True),
        chat(texts[3], temperature=0, dry_multiplier=0.8, tools=HOST_TOOLS,
             grammar=HOST_TOOL_GBNF, max_tokens=HOST_TOOL_TOKENS)]
    out = []
    for st, text, ms in concurrently(fns):
        assert st == 200, (st, text[:300])
        b = json.loads(text)
        b["client_ms"] = ms
        out.append(b)
    return out


def _check_host_wave(bodies, tok) -> dict:
    from llama_box_tpu_torch.grammar import Grammar
    js, gb, mi, tl = bodies
    c = js["choices"][0]
    obj = json.loads(c["message"]["content"])
    assert set(obj) == set(HOST_SCHEMA["required"]) \
        and c["finish_reason"] == "stop", c
    assert isinstance(obj["ok"], bool) and obj["n"] in \
        HOST_SCHEMA["properties"]["n"]["enum"], obj
    g = Grammar(HOST_GBNF, native=False)
    text = gb["choices"][0]["text"]
    assert g.accept_bytes(text.encode()) and g.completed, text
    assert gb["choices"][0]["finish_reason"] == "stop"
    assert mi["usage"]["completion_tokens"] == HOST_TOKENS
    c = tl["choices"][0]
    calls = c["message"].get("tool_calls") or []
    assert c["finish_reason"] == "tool_calls" and len(calls) == 1, c
    assert calls[0]["function"]["name"] == "get_weather"
    assert set(json.loads(calls[0]["function"]["arguments"])) == {"city"}
    return dict(json=obj, gbnf=text,
                mirostat=mi["choices"][0]["message"]["content"],
                tool=calls[0]["function"]["arguments"])


def _serve_engine(app, eng):
    """`app`'s routes over `eng` on a free local port: (url, close)."""
    import copy
    app2 = copy.copy(app)
    app2.engine = eng
    srv = app2.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def close():
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        eng.stop()
    return f"http://127.0.0.1:{srv.server_address[1]}", close


def host_phase(engine, app, seed, mode) -> dict:
    """Phase 7 on the path's model (its weights as served), in two modes,
    graphs (every key warmed first) and eager, each on fresh engines with
    the path's own settings (prefix cache on) behind the same routes: a
    plain greedy chat alone (chained) on an engine of its own; on a second
    engine the same chat beside a mirostat chat (one-token passes), then
    the host-controlled wave (host_wave) with the kernel counts from 0, a
    rate-limited request (X-Request-Tokens-Per-Second 20, 100 tokens,
    graphs only), /tokenize, /detokenize, /metrics and /lora-adapters.
    Both plain runs prefill their prompt cold. Texts identical in both
    modes, no graph captured in the measured requests, and each wave
    pass's device ms by CUDA events around its replay (graphs)."""
    from llama_box_tpu_torch import sampling
    from llama_box_tpu_torch.server.engine import Engine
    from llama_box_tpu_torch.server.metrics import Metrics
    phase = PATHS[mode][0].replace("5", "7")
    log(f"== phase {phase}: host-controlled decode, {mode} path: grammar, "
        f"json_schema, tools, mirostat, DRY, the rate header")
    from llama_box_tpu_torch.gguf import native
    t0 = time.perf_counter()
    native.grammar_lib()
    log(f"  grammar core {native.lib_path().name} ready in "
        f"{time.perf_counter() - t0:.2f} s")
    tok = engine.tokenizer
    rng = np.random.default_rng(seed + 31)
    texts = [make_prompt(tok, rng, HOST_PROMPT) for _ in range(4)]
    plain_text = make_prompt(tok, rng, HOST_PROMPT)
    counters = kernel_counters()

    def plain(url):
        return lambda: http(url + "/v1/chat/completions", dict(
            messages=[{"role": "user", "content": plain_text}],
            max_tokens=HOST_TOKENS, temperature=0))

    def fresh(kw):
        eng = Engine(engine.cfg, engine.params, tok,
                     dataclasses.replace(engine.ecfg, **kw),
                     device=str(engine.device))
        if eng.ecfg.cuda_graphs:
            warm_host_keys(eng)
        eng.start()
        return eng
    res, got = {}, {}
    for label, kw in HOST_MODES.items():
        # the plain chat alone, on an engine of its own: on the second
        # engine its prompt is not cached, so both runs prefill it whole
        eng = fresh(kw)
        url, close = _serve_engine(app, eng)
        try:
            st, text, _ = plain(url)()
            assert st == 200, (st, text[:300])
            alone = json.loads(text)
            spec_alone = eng.metrics.n_spec_chains
            # recorded, not checked: the same chat again, its prompt
            # cached but its last token, which prefills alone
            st, text, _ = plain(url)()
            a_text = alone["choices"][0]["message"]["content"]
            repeat_same = \
                json.loads(text)["choices"][0]["message"]["content"] == a_text
        finally:
            close()
        eng = fresh(kw)
        url, close = _serve_engine(app, eng)
        # host-sampler cost a token (by kind), the one-token passes' wall
        # and (graphs) each replay's device ms, from spies on the engine's
        # thread
        samp_ms = {"grammar": [], "mirostat": []}
        pass_ms, pass_dev = [], []
        sample = sampling.HostSampler.sample
        run = eng.graphs.run
        one = eng._one_token_pass

        def timed_sample(hs, logits, sample=sample, samp_ms=samp_ms):
            t0 = time.perf_counter()
            out = sample(hs, logits)
            kind = ("grammar" if hs.grammar is not None else
                    "mirostat" if hs.sp.mirostat else None)
            if kind:
                samp_ms[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        events = []

        def timed_run(key, fn, run=run, events=events):
            if key[0] != "one":
                return run(key, fn)
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            out = run(key, fn)
            b.record()
            events.append((a, b))
            return out

        def timed_pass(dec, *args, one=one, pass_ms=pass_ms,
                       pass_dev=pass_dev):
            n = len(events)
            t0 = time.perf_counter()
            one(dec, *args)
            pass_ms.append((time.perf_counter() - t0) * 1e3)
            # the pass waited for its copy, enqueued after b
            pass_dev.append(events[-1][0].elapsed_time(events[-1][1])
                            if len(events) > n else float("nan"))
        try:
            sampling.HostSampler.sample = timed_sample
            eng._one_token_pass = timed_pass
            if label == "graphs":
                eng.graphs.run = timed_run
            n_graphs = eng.graphs.n_graphs
            with urllib.request.urlopen(url + "/metrics") as r:
                m0 = _prom(r.read().decode())
            eng.metrics = Metrics()
            beside = concurrently([plain(url), lambda: http(
                url + "/v1/chat/completions", dict(
                    messages=[{"role": "user", "content": texts[2]}],
                    max_tokens=HOST_TOKENS, temperature=0.8,
                    seed=seed + 1, mirostat=2, ignore_eos=True))])
            b_plain, b_host = (json.loads(x[1]) for x in beside)
            assert pass_ms, "no one-token pass beside"
            p_text = b_plain["choices"][0]["message"]["content"]
            assert p_text == a_text, ("the plain greedy text beside a "
                                      "constrained request differs from "
                                      "its text alone")
            del pass_ms[:], pass_dev[:]
            for v in samp_ms.values():
                del v[:]
            # -- this slice's path: counts from 0 ---------------------------
            eng.metrics = Metrics()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            bodies = host_wave(url, texts, seed)
            wall = time.perf_counter() - t0
            launched = {k: fn.launches for k, fn in counters.items()}
            # -------------------------------------------------------------
            wave_samp = {k: list(v) for k, v in samp_ms.items()}
            wave_pass, wave_dev = list(pass_ms), list(pass_dev)
            for k, n in launched.items():
                if k in PATHS[mode][4]:
                    assert n > 0, f"{k} was never launched in phase {phase}"
                else:
                    assert n == 0, f"{k} launched on the {mode} path"
            checked = _check_host_wave(bodies, tok)
            out = dict(wall_s=wall, launches=launched, checked=checked,
                       plain_text=a_text, cached_repeat_same=repeat_same,
                       mirostat_beside=b_host["choices"][0]["message"][
                           "content"],
                       spec_chains_alone=spec_alone,
                       plain_alone_tok_s=alone["usage"]["tokens_per_second"],
                       plain_beside_tok_s=b_plain["usage"][
                           "tokens_per_second"],
                       constrained_tok_s={
                           k: b["usage"]["tokens_per_second"]
                           for k, b in zip(("json", "gbnf", "mirostat",
                                            "tool"), bodies)},
                       passes=len(wave_pass),
                       pass_wall_ms_p50=_pct(wave_pass, 50),
                       pass_wall_ms_p90=_pct(wave_pass, 90),
                       sampler_ms={k: dict(n=len(v), p50=_pct(v, 50),
                                           p90=_pct(v, 90))
                                   for k, v in wave_samp.items()})
            if label == "graphs":
                host = [w - d for w, d in zip(wave_pass, wave_dev)]
                out.update(pass_dev_ms_p50=_pct(wave_dev, 50),
                           pass_dev_ms_p90=_pct(wave_dev, 90),
                           pass_host_ms_p50=_pct(host, 50),
                           pass_host_ms_p90=_pct(host, 90),
                           pass_idle_share=1 - sum(wave_dev) / sum(wave_pass))
                eng.graphs.run = run
                out.update(rate_phase(eng, url, texts[0]))
                out["captured_in_measured"] = eng.graphs.n_graphs - n_graphs
                assert out["captured_in_measured"] == 0, \
                    "a graph was captured in phase 7's measured requests"
                out.update(one_pass_device_ms(eng))
            # the host-side routes
            st, text, _ = http(url + "/tokenize", {"content": texts[1],
                                                   "add_special": False})
            ids = json.loads(text)["tokens"]
            st, text, _ = http(url + "/detokenize", {"tokens": ids})
            assert json.loads(text)["content"] == texts[1], \
                "/tokenize then /detokenize did not round-trip"
            with urllib.request.urlopen(url + "/metrics") as r:
                m1 = _prom(r.read().decode())
            for k in ("llamabox:requests_total",
                      "llamabox:tokens_predicted_total",
                      "llamabox:prompt_tokens_total"):
                assert m1[k] > m0[k], k
            with urllib.request.urlopen(url + "/lora-adapters") as r:
                assert json.loads(r.read()) == []
            res[label] = out
            got[label] = dict(checked, plain=a_text,
                              beside=out["mirostat_beside"])
        finally:
            sampling.HostSampler.sample = sample
            eng.graphs.run = run
            close()
        sm = out["sampler_ms"]
        log(f"  {label:6s}: wave {out['wall_s']:.2f} s, {out['passes']} "
            f"one-token passes (wall p50 {out['pass_wall_ms_p50']:.3f} ms, "
            f"p90 {out['pass_wall_ms_p90']:.3f}); host sampler ms a token "
            + ", ".join(f"{k} p50 {v['p50']:.3f} p90 {v['p90']:.3f} "
                        f"(n {v['n']})" for k, v in sm.items()))
        log(f"          constrained tok/s {out['constrained_tok_s']}; plain "
            f"greedy tok/s alone {out['plain_alone_tok_s']:.1f} (chained, "
            f"{out['spec_chains_alone']} speculated), beside a mirostat "
            f"request {out['plain_beside_tok_s']:.1f}; same text; the "
            f"same chat again from the prefix cache (recorded): "
            f"{'same' if repeat_same else 'other'} text")
        if label == "graphs":
            log(f"          wave pass device ms (CUDA events around each "
                f"replay) p50 {out['pass_dev_ms_p50']:.5f} p90 "
                f"{out['pass_dev_ms_p90']:.5f}, host ms (wall - device, a "
                f"pass) p50 {out['pass_host_ms_p50']:.3f} p90 "
                f"{out['pass_host_ms_p90']:.3f}, device idle share "
                f"{out['pass_idle_share']:.4f}; one replay alone (all 4 "
                f"slots host-sampled) {out['one_pass_ms']:.5f} ms; "
                f"rate-limited {out['rate_tok_s']:.2f} tok/s after the "
                f"burst (header {RATE_TPS}); no graph captured in the "
                "measured requests")
    assert got["graphs"] == got["eager"], "a text differs, graphs vs eager"
    log(f"  json {got['graphs']['json']}, gbnf {got['graphs']['gbnf']!r}, "
        f"tool arguments {got['graphs']['tool']}; texts identical with "
        "graphs and eager; /tokenize -> /detokenize round-trips; /metrics "
        "counters grew; /lora-adapters []")
    return res


def rate_phase(eng, url, text) -> dict:
    """One greedy request with X-Request-Tokens-Per-Second RATE_TPS and
    RATE_TOKENS tokens; each token's time on the engine's thread; its
    rate from token RATE_FROM on (past the bucket's burst) must be within
    10 % of the header's."""
    rid = "phase7-rate"
    times = []
    accept = eng._accept_token

    def spy(s, token, *a, **kw):
        if s.task is not None and s.task.rid == rid:
            times.append(time.perf_counter())
        return accept(s, token, *a, **kw)
    eng._accept_token = spy
    try:
        st, body, ms = http(url + "/v1/chat/completions", dict(
            messages=[{"role": "user", "content": text}],
            max_tokens=RATE_TOKENS, temperature=0, ignore_eos=True),
            headers={"X-Request-Tokens-Per-Second": str(RATE_TPS),
                     "X-Request-ID": rid})
    finally:
        eng._accept_token = accept
    assert st == 200 and len(times) == RATE_TOKENS, (st, len(times))
    tps = (RATE_TOKENS - 1 - RATE_FROM) / (times[-1] - times[RATE_FROM])
    burst = RATE_FROM / (times[RATE_FROM] - times[0])
    assert abs(tps - RATE_TPS) <= 0.1 * RATE_TPS, \
        f"rate-limited request at {tps:.2f} tok/s, header {RATE_TPS}"
    return dict(rate_tok_s=tps, rate_first_tok_s=burst,
                rate_client_ms=ms)


def one_pass_device_ms(eng, n=30) -> dict:
    """Device ms of one one-token pass replay (4 slots decoding, all
    host-sampled, their rows gathered), by CUDA events, median of n."""
    S = len(eng.slots)
    key = ("one", False, 64)
    ms = []
    for i in range(n):
        eng._stage_one([400 + i] * S, [100] * S, list(range(S)))
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        eng.graphs.run(key, lambda: eng._one_token_program(
            samp_extras=False, samp_kcap=64))
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return dict(one_pass_ms=statistics.median(ms))


# ---------------------------------------------------------------------------
# phase 8: speculative decoding (the T-row verify pass, n-gram lookup,
# draft models) on the bf16 path's model; one self-drafting wave on the
# w8a8 and the q4 paths

SPEC_PROMPT, SPEC_TOKENS, SPEC_DRAFT = 160, 128, 8
# the eager engines' waves stop at 32 tokens a chat, held against plain
# decode's first 32: their hosts launch every kernel of every draft round
SPEC_EAGER_TOKENS = 32
DRAFT_LAYERS = 2
# the least share of a self-draft's drafts the target accepts. The synthetic
# model's greedy steps are near ties (top-2 margins of a bf16 ulp), so the
# draft's argmax parts from the target's pick wherever their logits differ
# by a rounding: its cache rows of accepted tails come from prefill passes
# and, on the bf16 and q4 paths, the row-count-dependent norm (verify_bits)
# moves verify rows; an ignore_eos request never takes the end token where
# it is the argmax. A draft cache that lost its rows (a missed catch-up, a
# shift not applied to it) would accept next to none, as the unrelated
# 2-layer draft does
SELF_ACCEPT_MIN = 0.3
# phase 8's modes of each speculative configuration: label -> EngineConfig
# fields; every graph is captured before a measured wave
SPEC_MODES = {"graphs": {}, "lockstep": dict(pipeline_chain=False),
              "eager": dict(cuda_graphs=False, pipeline_chain=False)}


def spec_chat(url, text, n=SPEC_TOKENS):
    """One greedy ignore_eos chat of n tokens with its top-2 log-probs."""
    st, body, ms = http(url + "/v1/chat/completions", dict(
        messages=[{"role": "user", "content": text}], max_tokens=n,
        temperature=0, ignore_eos=True, logprobs=True, top_logprobs=2))
    assert st == 200, (st, body[:300])
    b = json.loads(body)
    assert b["usage"]["completion_tokens"] == n, b["usage"]
    return b


def spec_wave(url, eng, texts, n=SPEC_TOKENS) -> dict:
    """The chats at once on a served engine (its metrics from 0): their
    tokens and margins, drafted and accepted counts (usage and /metrics
    agree), decode tok/s by the engine's rule (from each program's
    dispatch), the wave's tokens over its wall, TTFT p50 and the passes
    speculated (dispatched before the host synced the one before)."""
    from llama_box_tpu_torch.server.metrics import Metrics
    eng.metrics = Metrics()
    t0 = time.perf_counter()
    bodies = concurrently([lambda t=t: spec_chat(url, t, n) for t in texts])
    wall = time.perf_counter() - t0
    m = eng.metrics.snapshot()
    drafted = sum(b["usage"].get("draft_tokens", 0) for b in bodies)
    assert drafted == m["n_drafted_total"], (drafted, m["n_drafted_total"])
    return dict(margins=[_margins(b) for b in bodies], wall_s=wall,
                decode_tok_s=m["n_decode_total"] / m["t_decode_total_ms"]
                * 1e3,
                window_tok_s=len(texts) * n / wall,
                drafted=drafted, accepted=m["n_drafted_accepted_total"],
                acceptance=(m["n_drafted_accepted_total"] / drafted
                            if drafted else None),
                speculated=m["n_spec_chains"],
                ttft_p50_ms=statistics.median(
                    b["usage"]["time_to_first_token_ms"] for b in bodies))


def same_to_near_tie(got, want) -> list:
    """Per request: the tokens compared, up to the first step where either
    run's top-2 margin is a near tie (NEAR_TIE), where the texts must be
    equal; whether the whole texts are; and where they part (None) with
    the reference's margin there."""
    out = []
    for a, b in zip(got, want):
        j = next((i for i, ((_, ma), (_, mb)) in enumerate(zip(a, b))
                  if min(ma, mb) <= NEAR_TIE), len(a))
        ta, tb = [t for t, _ in a], [t for t, _ in b]
        part = next((i for i in range(min(len(ta), len(tb)))
                     if ta[i] != tb[i]), None)
        assert part is None or part >= j, (
            f"a speculative text parts from plain chained decode at token "
            f"{part} of {len(ta)}, before a near tie")
        out.append((j, ta == tb, part,
                    None if part is None else round(b[part][1], 5)))
    return out


def _stage_spec(eng, tokens, pos):
    S = len(eng.slots)
    h = eng._spec_in.host()
    h[:] = 0
    h[S:2 * S] = eng.slot_ctx
    for b, (t, p) in enumerate(zip(tokens, pos)):
        if t is not None:
            h[b], h[S + b], h[2 * S + b], h[3 * S + b] = t, p, 1, 1
    eng._spec_in.push()


def warm_spec_keys(eng) -> None:
    """Every program key phase 8's waves (greedy ignore_eos chats with
    log-probs, far from the slots' capacity) can meet, run twice (its
    eager first use, then its capture): the prefill buckets (and the
    draft's catch-up buckets), the decode chains, the one-token pass at 1
    and 1 + draft_max rows and, with a draft model, the M-round pass."""
    S = len(eng.slots)
    K = eng.ecfg.draft_max
    kw = dict(samp_extras=True)
    progs = [("prefill", eng._prefill_program)]
    if eng.draft_params is not None:
        progs.append(("draft_prefill", eng._draft_prefill_program))
    runs = []
    for B in eng.buckets:
        for name, prog in progs:
            runs.append(((name, B), lambda B=B: _stage_prefill(
                eng, {0: (0, [400] * B)}, B), lambda B=B, p=prog: p(B)))
    n = 1
    while n <= eng.ecfg.decode_chain:
        runs.append(((("decode", n, True, 0)), lambda: _stage_decode(
            eng, [400] + [None] * (S - 1), [0] * S),
            lambda n=n: eng._decode_program(n, **kw)))
        n *= 2
    for rows in (1, 1 + K):
        runs.append((("one", True, 0) if rows == 1 else
                     ("verify", rows, True, 0),
                     lambda rows=rows: eng._stage_one(
                         [[400] * rows] + [None] * (S - 1), [0] * S, []),
                     lambda rows=rows: eng._one_token_program(rows, **kw)))
    M = eng.ecfg.spec_rounds
    if eng.draft_params is not None and M > 1:
        runs.append((("spec", M, K, True, 0), lambda: _stage_spec(
            eng, [400] + [None] * (S - 1), [0] * S),
            lambda: eng._spec_program(M, True, **kw)))
    for key, stage, prog in runs:
        for _ in range(2):
            stage()
            eng._refresh_arrs()
            eng.graphs.run(key, prog)
    torch.cuda.synchronize()


def verify_bits(engine, seed) -> dict:
    """A verify forward of T = 1 + SPEC_DRAFT rows a slot (4 slots, from
    positions 37 to 211 after a prefill) against T one-row decode steps
    on a copy of the same cache, bf16 and int8 caches: whether the logits
    and the cache are equal bit for bit, and the logits' largest
    difference."""
    from llama_box_tpu_torch.models import llama
    cfg, params, dev = engine.cfg, engine.params, engine.device
    S, C, T = N_SLOTS, 512, 1 + SPEC_DRAFT
    rng = np.random.default_rng(seed + 41)
    n = np.array([100, 37, 211, 64])
    pre = torch.from_numpy(rng.integers(300, V, (S, 256)))
    rows = torch.from_numpy(rng.integers(300, V, (S, T)))
    pos = n[:, None] + np.arange(T)
    cos, sin = llama.make_rope(cfg, C, dev)
    out = {}
    for tag, dt in _KV_TORCH.items():
        kv = llama.init_kv_cache(cfg, S, C, dt, dev)
        llama.prefill_batch_impl(params, cfg, pre, np.zeros(S, np.int64), n,
                                 kv, cos, sin)
        kv2 = llama.KVCache(*[x.clone() if x is not None else None
                              for x in kv])
        got = llama.forward_impl(params, cfg, rows, pos, kv, cos, sin)[0]
        want = torch.cat([llama.forward_impl(
            params, cfg, rows[:, j:j + 1], pos[:, j:j + 1].copy(), kv2, cos,
            sin)[0] for j in range(T)], dim=1)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.isfinite(want).all()
        out[tag] = dict(
            logits_equal=torch.equal(got, want),
            max_abs_diff=float((got - want).abs().max()),
            kv_equal=all(torch.equal(a, b)
                         for a, b in zip(_leaves(kv), _leaves(kv2))))
        if not out[tag]["logits_equal"]:
            out[tag]["first_parting_op"] = first_parting_op(
                engine, dt, pre, n, rows, cos, sin)
    return out


_RECORDED = ("_embed_tokens", "norm_any", "rms_norm", "mm", "apply_rope",
             "flash_decode", "_act", "fused_norm_qmm", "fused_layer_tail")


def first_parting_op(engine, dt, pre, n, rows, cos, sin) -> dict:
    """Where a verify forward's bits first part from its one-row steps':
    each op of models/llama (as _RECORDED names them) is recorded in both
    runs, a verify output's row j held against step j's output; returns
    the first op (in the steps' order) whose bits differ, with its layer
    ("output": the output norm and projection) and row."""
    from llama_box_tpu_torch.models import llama
    cfg, params, dev = engine.cfg, engine.params, engine.device
    S, T = rows.shape
    kv0 = llama.init_kv_cache(cfg, S, 512, dt, dev)
    llama.prefill_batch_impl(params, cfg, pre, np.zeros(S, np.int64), n,
                             kv0, cos, sin)
    log, saved = [], {}

    def rec(name, f):
        def g(*a, **k):
            o = f(*a, **k)
            log.append((name, o.clone()))
            return o
        return g

    def layer(f):
        def g(x, lp, li, *a, **k):
            log.append(("layer", li))
            o = f(x, lp, li, *a, **k)
            log.append(("layer", -1))
            return o
        return g
    for name in _RECORDED:
        if hasattr(llama, name):
            saved[name] = getattr(llama, name)
            setattr(llama, name, rec(name, saved[name]))
    saved["_attn_layer"] = llama._attn_layer
    llama._attn_layer = layer(saved["_attn_layer"])
    try:
        pos = n[:, None] + np.arange(T)
        llama.forward_impl(params, cfg, rows, pos, llama.KVCache(
            *[x.clone() if x is not None else None for x in kv0]), cos, sin)
        vlog = list(log)
        kv, steps = llama.KVCache(*[x.clone() if x is not None else None
                                    for x in kv0]), []
        for j in range(T):
            del log[:]
            llama.forward_impl(params, cfg, rows[:, j:j + 1],
                               pos[:, j:j + 1].copy(), kv, cos, sin)
            steps.append(list(log))
    finally:
        for name, f in saved.items():
            setattr(llama, name, f)
    torch.cuda.synchronize()
    found = None
    for j in range(T):
        vi, li = 0, -1
        for si, (name, o) in enumerate(steps[j]):
            while vlog[vi][0] != name:
                vi += 1
            if name == "layer":
                li = o
                vi += 1
                continue
            if name == "flash_decode":
                ok = torch.equal(vlog[vi + j][1], o)
                vi += T
            else:
                v = vlog[vi][1]
                ok = torch.equal(v.reshape(S, T, -1)[:, j],
                                 o.reshape(S, 1, -1)[:, 0])
                vi += 1
            if not ok:
                if found is None or si < found["op_index"]:
                    found = dict(op=name, op_index=si, row=j,
                                 layer=li if li >= 0 else "output")
                break
    return found


def verify_costs(eng, n=30) -> dict:
    """Device ms (CUDA events around a replay, median of n after 2) of one
    verify pass of T = 1 + draft_max rows a slot (4 slots, draft_max
    drafts each, from position 300), one one-row pass and one 16-step
    chain, and the flash decode launches of one verify pass, on a warmed
    graphs engine whose loop is idle."""
    from llama_box_tpu_torch.ops.flash_decode import flash_decode
    S, T = len(eng.slots), 1 + eng.ecfg.draft_max
    kw = dict(samp_extras=True)

    def timed(stage, key, prog):
        ms = []
        for i in range(n + 2):
            stage(i)
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            eng.graphs.run(key, prog)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms[2:])
    out = dict(
        verify_ms=timed(lambda i: eng._stage_one(
            [[400 + i] * T] * S, [300] * S, []), ("verify", T, True, 0),
            lambda: eng._one_token_program(T, **kw)),
        one_ms=timed(lambda i: eng._stage_one([400 + i] * S, [300] * S, []),
                     ("one", True, 0),
                     lambda: eng._one_token_program(1, **kw)),
        chain16_ms=timed(lambda i: _stage_decode(eng, [400 + i] * S,
                                                 [300] * S),
                         ("decode", 16, True, 0),
                         lambda: eng._decode_program(16, **kw)))
    flash_decode.launches = 0
    eng._stage_one([[400] * T] * S, [300] * S, [])
    eng.graphs.run(("verify", T, True, 0),
                   lambda: eng._one_token_program(T, **kw))
    torch.cuda.synchronize()
    out["flash_decode_per_verify"] = flash_decode.launches
    return out


def _spec_engine(engine, draft, ecfg):
    from llama_box_tpu_torch.server.engine import Engine
    return Engine(engine.cfg, engine.params, engine.tokenizer, ecfg,
                  device=str(engine.device), draft=draft)


def spec_run(app, eng, texts, warm_texts, counters=None, srv=None,
             costs=False, n=SPEC_TOKENS) -> dict:
    """Warm `eng` when it has graphs (every key captured, then one wave of
    other prompts), serve it (by `srv`, a CLI server whose engine already
    runs, or by `app`'s routes) and run the measured wave of `n` tokens a
    chat, the kernel counts from 0 when `counters` is given; no graph may
    be captured in it. `costs`: verify_costs after the wave. The engine
    is stopped."""
    if eng.ecfg.cuda_graphs:
        warm_spec_keys(eng)      # the loop, if running, is idle
    if srv is None:
        eng.start()
        url, close = _serve_engine(app, eng)
    else:
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"

        def close():
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
            eng.stop()
    try:
        if eng.ecfg.cuda_graphs:      # an eager engine captures nothing
            spec_wave(url, eng, warm_texts)
        n_graphs = eng.graphs.n_graphs
        if counters:
            for fn in counters.values():
                fn.launches = 0
        w = spec_wave(url, eng, texts, n)
        if counters:
            w["launches"] = {k: fn.launches for k, fn in counters.items()}
        w.update(captured_in_measured=eng.graphs.n_graphs - n_graphs,
                 graphs=eng.graphs.n_graphs,
                 graph_pool_mib=eng.graphs.pool_bytes / 2**20)
        assert w["captured_in_measured"] == 0, \
            "a graph was captured in a measured speculative wave"
        with urllib.request.urlopen(url + "/metrics") as r:
            w["prom_drafted"] = _prom(r.read().decode())[
                "llamabox:tokens_drafted_total"]
        with urllib.request.urlopen(url + "/v1/models") as r:
            w["support_speculative"] = json.loads(r.read())["data"][0][
                "meta"]["support_speculative"]
        if costs:
            w["verify_costs"] = verify_costs(eng)
    finally:
        close()
    return w


def _log_wave(label, w):
    vs = w.get("vs_plain")
    log(f"  {label:15s}: decode {w['decode_tok_s']:8.1f} tok/s, window "
        f"{w['window_tok_s']:8.1f} tok/s, TTFT p50 {w['ttft_p50_ms']:.2f} "
        f"ms, drafted {w['drafted']}, accepted {w['accepted']}"
        + (f" ({w['acceptance']:.4f})" if w["acceptance"] is not None
           else "")
        + f", speculated {w['speculated']}, {w['graphs']} graphs, pool "
        f"{w['graph_pool_mib']:.1f} MiB"
        + (f"; vs plain chained: tokens compared {[v[0] for v in vs]}, "
           f"texts part at (token, plain's top-2 margin) "
           f"{[(v[2], v[3]) for v in vs]}" if vs else ""))


def spec_path_phase(engine, app, seed, mode) -> dict:
    """Phase 8w/8q: on the path's model, plain chained decode and then one
    self-drafting wave (the served params as the draft, --draft-p-min 0,
    graphs, every key captured first) of the same chats; the path's
    kernels must run in it; and the verify rows' bits against the one-row
    steps'."""
    phase = PATHS[mode][0].replace("5", "8")
    log(f"== phase {phase}: speculative decoding, {mode} path: a "
        "self-drafting wave")
    tok = engine.tokenizer
    rng = np.random.default_rng(seed + 51)
    texts = [make_prompt(tok, rng, SPEC_PROMPT) for _ in range(N_SLOTS)]
    warm = [make_prompt(tok, rng, SPEC_PROMPT) for _ in range(N_SLOTS)]
    counters = kernel_counters()
    waves = {"plain16": spec_run(app, _spec_engine(engine, None,
                                                   engine.ecfg), texts, warm)}
    w = waves["self"] = spec_run(app, _spec_engine(
        engine, (engine.cfg, engine.params), dataclasses.replace(
            engine.ecfg, draft_max=SPEC_DRAFT, draft_p_min=0.0)),
        texts, warm, counters)
    for k, n in w["launches"].items():
        if k in PATHS[mode][4]:
            assert n > 0, f"{k} was never launched in phase {phase}"
        else:
            assert n == 0, f"{k} launched on the {mode} path"
    assert w["drafted"] > 0 and w["support_speculative"]
    w["vs_plain"] = same_to_near_tie(w["margins"], waves["plain16"]["margins"])
    for label, x in waves.items():
        _log_wave(label, x)
        x.pop("margins")
    log(f"  launches in the self-drafting wave: {w['launches']}")
    bits = verify_bits(engine, seed)
    log(f"  verify rows vs one-row steps: {bits}")
    return dict(waves=waves, bits=bits)


def spec_phase(dev, seed, tmp, path, engine, app) -> dict:
    """Phase 8 on the bf16 path's model (see the module docstring)."""
    from llama_box_tpu_torch import cli
    log("== phase 8: speculative decoding, bf16 path: n-gram lookup, "
        "self-draft, a 2-layer draft; graphs pipelined, lockstep, eager")
    t_phase = time.perf_counter()
    tok = engine.tokenizer
    rng = np.random.default_rng(seed + 53)
    texts = [make_prompt(tok, rng, SPEC_PROMPT) for _ in range(N_SLOTS)]
    warm = [make_prompt(tok, rng, SPEC_PROMPT) for _ in range(N_SLOTS)]
    counters = kernel_counters()
    dpath = f"{tmp}/synthetic-tinyllama-1.1b-{DRAFT_LAYERS}-layers-f16.gguf"
    write_model(dpath, seed, "f16", n_layers=DRAFT_LAYERS)
    flags = {"ngram": ["--lookup-ngram-min", "2", "--draft-max",
                       str(SPEC_DRAFT), "--decode-chain", "1"],
             "draft2": ["--decode-chain", str(CHAIN), "-md", dpath,
                        "--draft-max", str(SPEC_DRAFT), "--draft-p-min",
                        "0"]}
    ecfgs = {"plain16": engine.ecfg,
             "plain1": dataclasses.replace(engine.ecfg, decode_chain=1),
             "ngram": dataclasses.replace(
                 engine.ecfg, lookup_ngram_min=2, draft_max=SPEC_DRAFT,
                 decode_chain=1),
             "self": dataclasses.replace(engine.ecfg, draft_max=SPEC_DRAFT,
                                         draft_p_min=0.0)}
    ecfgs["draft2"] = ecfgs["self"]
    drafts = {"self": (engine.cfg, engine.params)}
    waves = {}
    for label in ("plain16", "plain1"):
        waves[label] = spec_run(app, _spec_engine(engine, None,
                                                  ecfgs[label]), texts, warm)
    # the CLI's own servers (the main path of this phase): graphs,
    # pipelined; the kernel counts from 0 over the measured wave
    for label in ("ngram", "draft2"):
        t0 = time.perf_counter()
        eng, srv = cli.build_server([
            "-m", path, "--port", "0", "-np", str(N_SLOTS), "-c", str(N_CTX),
            "-ub", str(N_UBATCH), "--no-jinja", "--device", dev.type]
            + flags[label])
        log(f"  CLI server {' '.join(flags[label])}: up in "
            f"{time.perf_counter() - t0:.1f} s")
        assert eng.ecfg == ecfgs[label], \
            f"{label}: the CLI's EngineConfig is not the in-process one"
        if label == "draft2":
            drafts[label] = (eng.draft_cfg, eng.draft_params)
        waves[label + "_graphs"] = spec_run(None, eng, texts, warm, counters,
                                            srv=srv)
        del eng, srv
    for label in ("ngram", "self", "draft2"):
        for mode, kw in SPEC_MODES.items():
            if mode == "graphs" and label != "self":
                continue           # served by the CLI above
            waves[f"{label}_{mode}"] = spec_run(
                app, _spec_engine(engine, drafts.get(label),
                                  dataclasses.replace(ecfgs[label], **kw)),
                texts, warm, counters if mode == "graphs" else None,
                costs=mode == "graphs",
                n=SPEC_EAGER_TOKENS if mode == "eager" else SPEC_TOKENS)
    ref = waves["plain16"]["margins"]
    for label, w in waves.items():
        if not label.startswith("plain"):
            assert w["drafted"] > 0, f"{label}: nothing was drafted"
            assert w["prom_drafted"] == w["drafted"] and \
                w["support_speculative"], label
            w["vs_plain"] = same_to_near_tie(
                w["margins"], [m[:len(g)] for g, m in zip(w["margins"],
                                                         ref)])
        _log_wave(label, w)
        w.pop("margins")
    s = waves["self_graphs"]
    assert s["accepted"] >= SELF_ACCEPT_MIN * s["drafted"], \
        "the self-draft's drafts were rejected"
    for label in ("ngram_graphs", "self_graphs", "draft2_graphs"):
        lc = waves[label]["launches"]
        for k, n in lc.items():
            if k in PATHS["bf16"][4]:
                assert n > 0, f"{k} was never launched in {label}"
            else:
                assert n == 0, f"{k} launched in {label}"
        log(f"  launches in the {label} wave: {lc}")
    vc = s.pop("verify_costs")
    log(f"  device ms (a replay, median of 30): a verify pass of T "
        f"{1 + SPEC_DRAFT} rows {vc['verify_ms']:.5f}, a one-row pass "
        f"{vc['one_ms']:.5f}, a 16-step chain {vc['chain16_ms']:.5f}; "
        f"flash decode launches a verify pass "
        f"{vc['flash_decode_per_verify']}")
    res = dict(waves=waves, verify_costs=vc,
               shift=spec_shift_run(engine, seed),
               bits=verify_bits(engine, seed))
    log(f"  verify rows vs one-row steps: {res['bits']}")
    os.remove(dpath)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 8: {res['seconds']:.1f} s")
    return res


def spec_shift_run(engine, seed) -> dict:
    """Self-drafting past a slot's capacity (-np 4 -c SHIFT_CTX: 512 a
    slot; 4 greedy requests of 200 to 350 prompt tokens, SHIFT_TOKENS
    tokens each, on the engine's task API: an HTTP request may not ask
    for more tokens than a slot holds) against plain chained decode of
    the same: the same texts up to a near tie, at least 2 shifts a
    request, acceptance >= 0.7 (the draft cache shifts with the
    target's)."""
    from llama_box_tpu_torch.sampling import SamplerParams
    from llama_box_tpu_torch.server.task import CompletionsTask
    tok = engine.tokenizer
    rng = np.random.default_rng(seed + 57)
    prompts = [rng.integers(300, V, n).tolist() for n in SHIFT_PROMPTS]
    out = {}
    for label, draft, kw in (
            ("plain16", None, {}),
            ("self", (engine.cfg, engine.params),
             dict(draft_max=SPEC_DRAFT, draft_p_min=0.0))):
        eng = _spec_engine(engine, draft, dataclasses.replace(
            engine.ecfg, n_ctx=SHIFT_CTX, **kw))
        eng.start()
        try:
            tasks = [CompletionsTask(p, SamplerParams(temp=0.0,
                                                      ignore_eos=True),
                                     tokenizer=tok, max_tokens=SHIFT_TOKENS,
                                     n_probs=2) for p in prompts]
            t0 = time.perf_counter()
            for t in tasks:
                eng.submit(t)
            finals = [wait_final(t) for t in tasks]
            m = eng.metrics.snapshot()
        finally:
            eng.stop()
        out[label] = dict(
            wall_s=time.perf_counter() - t0,
            margins=[[(p.token, float(np.log(p.top_probs[0])
                                      - np.log(p.top_probs[1])))
                      for p in f.probs] for f in finals],
            shifts=[f.n_shifted for f in finals],
            drafted=m["n_drafted_total"],
            accepted=m["n_drafted_accepted_total"])
        assert min(out[label]["shifts"]) >= 2, out[label]["shifts"]
    s = out["self"]
    s["vs_plain"] = same_to_near_tie(s.pop("margins"),
                                     out["plain16"].pop("margins"))
    assert s["drafted"] > 0 and \
        s["accepted"] >= SELF_ACCEPT_MIN * s["drafted"], s
    log(f"  self-draft past the capacity (-c {SHIFT_CTX}, {SHIFT_TOKENS} "
        f"tokens, shifts {s['shifts']}): {s['wall_s']:.2f} s, drafted "
        f"{s['drafted']}, accepted {s['accepted']}; vs plain chained "
        f"({out['plain16']['wall_s']:.2f} s): tokens compared "
        f"{[v[0] for v in s['vs_plain']]}, texts part at (token, margin) "
        f"{[(v[2], v[3]) for v in s['vs_plain']]}")
    return out


# ---------------------------------------------------------------------------
# phase 10: embeddings and rerank (the BERT encoder at BAAI/bge-base-en-v1.5's
# widths; the llama embedding pass on each served path)

# bge-base-en-v1.5's published widths (BERT-base): 12 layers, 768 wide, 12
# heads, FF 3072, 512 positions, a 30522-piece WordPiece vocab
BL, BE, BH, BFF, BPOS, BV = 12, 768, 12, 3072, 512, 30522
EMB_INPUTS, EMB_LENS = 64, (16, 500)      # one /v1/embeddings request
RERANK_DOCS, RERANK_LENS = 32, (20, 200)  # one /v1/rerank query
LLAMA_EMB_INPUTS, LLAMA_EMB_LENS = 32, (16, 64)
LLAMA_CHATS, LLAMA_CHAT_TOKENS = 3, 256
BERT_COS, LLAMA_COS = 0.999, 0.99         # against the f32 CPU forward
# a raw rerank score (cls_out's column 0, about N(0, 0.3) on these weights)
# within RERANK_ATOL of the f32 CPU encoder's; two documents whose CPU
# scores lie within twice that may swap places in the top 5
RERANK_ATOL = 0.02
EMBED_KEY_ROWS, EMBED_KEY_T = 8, 512      # the replay timed on each model


def wordpiece_vocab() -> list:
    """[PAD] [UNK] [CLS] [SEP] [MASK], then the 1- to 3-letter words and
    their ## continuations, up to BV pieces."""
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    words = letters + [a + b for a in letters for b in letters]
    words += [a + b + c for a in letters for b in letters for c in letters]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words \
        + ["##" + w for w in words]
    return vocab[:BV]


def write_bert(path: str, seed: int, rank: bool) -> None:
    """A BERT GGUF at bge-base's widths (pooling cls) or, with `rank`, a
    cross-encoder of the same widths with a classification head
    (cls.weight [768, 768], cls.output.weight [1, 768], pooling rank).
    F16 matrices and F32 vectors of random floats from `seed`: weights and
    biases N(0, 0.02) (BERT's initializer range), norm weights 1 + N(0,
    0.02). The tokenizer keys are a BERT conversion's: [CLS] as BOS and
    [SEP] as EOS, both added."""
    from llama_box_tpu_torch.gguf import GGMLType, GGUFWriter
    rng = np.random.default_rng(seed + (1 if rank else 0))
    vocab = wordpiece_vocab()
    w = GGUFWriter(path, architecture="bert")
    for k, v in (("general.name", "synthetic-bge-base-en-v1.5"
                  + ("-reranker" if rank else "")),
                 ("bert.block_count", BL), ("bert.context_length", BPOS),
                 ("bert.embedding_length", BE),
                 ("bert.feed_forward_length", BFF),
                 ("bert.attention.head_count", BH),
                 ("bert.attention.layer_norm_epsilon", 1e-12),
                 ("bert.attention.causal", False),
                 ("bert.pooling_type", 4 if rank else 2),
                 ("tokenizer.ggml.model", "bert"),
                 ("tokenizer.ggml.tokens", vocab),
                 ("tokenizer.ggml.token_type", np.asarray(
                     [3] * 5 + [1] * (BV - 5), np.int32)),
                 ("tokenizer.ggml.unknown_token_id", 1),
                 ("tokenizer.ggml.padding_token_id", 0),
                 ("tokenizer.ggml.cls_token_id", 2),
                 ("tokenizer.ggml.seperator_token_id", 3),
                 ("tokenizer.ggml.bos_token_id", 2),
                 ("tokenizer.ggml.eos_token_id", 3),
                 ("tokenizer.ggml.add_bos_token", True),
                 ("tokenizer.ggml.add_eos_token", True)):
        w.add_kv(k, v)

    def rand(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    f16 = GGMLType.F16
    w.add_tensor("token_embd.weight", rand(BV, BE), f16)
    w.add_tensor("token_types.weight", rand(2, BE), f16)
    w.add_tensor("position_embd.weight", rand(BPOS, BE), f16)
    w.add_tensor("token_embd_norm.weight", 1.0 + rand(BE))
    w.add_tensor("token_embd_norm.bias", rand(BE))
    for i in range(BL):
        p = f"blk.{i}."
        for name, (o, n) in (("attn_q", (BE, BE)), ("attn_k", (BE, BE)),
                             ("attn_v", (BE, BE)),
                             ("attn_output", (BE, BE)),
                             ("ffn_up", (BFF, BE)), ("ffn_down", (BE, BFF))):
            w.add_tensor(p + name + ".weight", rand(o, n), f16)
            w.add_tensor(p + name + ".bias", rand(o))
        for name in ("attn_output_norm", "layer_output_norm"):
            w.add_tensor(p + name + ".weight", 1.0 + rand(BE))
            w.add_tensor(p + name + ".bias", rand(BE))
    if rank:
        w.add_tensor("cls.weight", rand(BE, BE), f16)
        w.add_tensor("cls.bias", rand(BE))
        w.add_tensor("cls.output.weight", rand(1, BE), f16)
        w.add_tensor("cls.output.bias", rand(1))
    w.write()


def make_text(tok, rng, n_target: int) -> str:
    """Random letter words whose tokens (specials included) come close to
    n_target."""
    words = ["".join(chr(ord("a") + c) for c in rng.integers(0, 26, n))
             for n in rng.integers(2, 7, 2 * n_target)]
    lo, hi = 1, len(words)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if len(tok.encode(" ".join(words[:mid]))) <= n_target:
            lo = mid
        else:
            hi = mid - 1
    return " ".join(words[:lo])


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _row_cos(a, b) -> np.ndarray:
    return (_unit(a) * _unit(b)).sum(-1)


def cpu_pooled(fwd, ids: list, group: int = 8) -> np.ndarray:
    """fwd(tokens [B, T], lens [B]) on the CPU over token lists, in groups
    of `group` sorted by length (padding changes no pooled row); rows back
    in input order, f64."""
    order = sorted(range(len(ids)), key=lambda i: len(ids[i]))
    out = [None] * len(ids)
    for k in range(0, len(order), group):
        g = order[k:k + group]
        T = max(len(ids[j]) for j in g)
        toks = np.zeros((len(g), T), np.int64)
        for b, j in enumerate(g):
            toks[b, :len(ids[j])] = ids[j]
        with torch.no_grad():
            res = fwd(torch.from_numpy(toks),
                      torch.tensor([len(ids[j]) for j in g]))
        for b, j in enumerate(g):
            out[j] = res[b].double().numpy()
    return np.stack(out)


def _stage_embed(eng, lists, R, T):
    """Stage an embed pass as Engine._embed_pass does: seq_lens [R] then
    tokens [R, T]."""
    h = eng._emb_in.host()
    h[:R * (1 + T)] = 0
    toks = h[R:R * (1 + T)].reshape(R, T)
    for b, ids in enumerate(lists):
        toks[b, :len(ids)] = ids[:T]
        h[b] = min(len(ids), T)
    eng._emb_in.push(R * (1 + T))


def embed_work(eng, R, T) -> tuple[float, float]:
    """(bytes, operations) of one embed pass of R full rows of T tokens:
    every 2D weight the stack multiplies read once, the token rows read
    and the pooled rows written; 2 x rows x in x out a product, and the
    attention's q.k and p.v over the pairs the mask keeps (all T^2 for
    the BERT encoder, T(T+1)/2 causal), a head each."""
    cfg, p = eng.cfg, eng.params
    lay = p["layers"]
    mats = [k for k in lay if k.startswith("w")]
    per_layer = sum(int(np.prod(lay[k].shape[1:])) for k in mats)
    bytes_w = sum(lay[k].numel() * lay[k].element_size() for k in mats)
    rows = R * T
    pairs = T * T if eng.bert else T * (T + 1) // 2
    D = cfg.head_dim or cfg.n_embd // cfg.n_heads
    flops = 2 * rows * per_layer * cfg.n_layers \
        + 2 * 2 * R * cfg.n_heads * pairs * D * cfg.n_layers
    emb = p["tok_embd"]
    nbytes = bytes_w + rows * (8 + cfg.n_embd * emb.element_size()) \
        + R * 4 * cfg.n_embd
    return nbytes, flops


def embed_replay(eng, lists, pooling, flush) -> dict:
    """One ("embed", R, T, pooling) key at R = 8 rows of T = 512 tokens:
    staged, run eagerly (Engine._embed_program, no runner), then through
    the runner (its eager first use, its capture, then replays): the
    replay bit-equal to the eager output; the device ms of one replay
    (median of 15, L2 flushed) beside its bound."""
    R, T = EMBED_KEY_ROWS, EMBED_KEY_T
    key = ("embed", R, T, pooling)
    fn = lambda: eng._embed_program(R, T, pooling)  # noqa: E731
    _stage_embed(eng, lists, R, T)
    eager = fn().clone()
    for _ in range(3):
        out = eng.graphs.run(key, fn)
    torch.cuda.synchronize()
    equal = bool(torch.equal(out, eager))
    assert equal, f"{key}: the replay differs from the eager pass"
    ms = device_ms(lambda: eng.graphs.run(key, fn), flush)
    nbytes, flops = embed_work(eng, R, T)
    bms, by = bound_ms(nbytes, flops)
    return dict(key=list(key), replay_equals_eager=equal, ms=ms,
                bound_ms=bms, bound_by=by, tflop=flops / 1e12)


def _post_ok(url, body):
    st, text, ms = http(url, body)
    assert st == 200, (st, text[:300])
    return json.loads(text), ms


def bert_embed_phase(dev, seed, tmp, flush) -> dict:
    """bge-base's widths through the CLI with --embeddings: one request of
    EMB_INPUTS texts (float, then base64), warmed first; every vector
    against the f32 CPU encoder."""
    import base64

    from llama_box_tpu_torch import cli
    from llama_box_tpu_torch.models.bert import bert_forward
    path = f"{tmp}/synthetic-bge-base-en-v1.5-f16.gguf"
    t0 = time.perf_counter()
    write_bert(path, seed, rank=False)
    eng, srv = cli.build_server(["-m", path, "--port", "0", "--device",
                                 dev.type, "--embeddings"])
    os.remove(path)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    log(f"  bge-base width (bert, {BL} x {BE}, pooling {eng.cfg.pooling}, "
        f"{eng.params['tok_embd'].dtype}): written and served in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        tok = eng.tokenizer
        rng = np.random.default_rng(seed + 71)
        texts = [make_text(tok, rng, int(n)) for n in
                 rng.integers(EMB_LENS[0], EMB_LENS[1] + 1, EMB_INPUTS)]
        ids = [tok.encode(t) for t in texts]
        body = {"input": texts}
        for _ in range(2):        # each key's eager first use, its capture
            _post_ok(url + "/v1/embeddings", body)
        n_graphs, seen = eng.graphs.n_graphs, set(eng.graphs._seen)
        got, ms = _post_ok(url + "/v1/embeddings", body)
        b64, _ = _post_ok(url + "/v1/embeddings",
                          dict(body, encoding_format="base64"))
        assert eng.graphs.n_graphs == n_graphs and \
            eng.graphs._seen == seen, "a graph was captured in phase 10"
        vecs = np.array([d["embedding"] for d in got["data"]])
        dec = np.array([np.frombuffer(base64.b64decode(d["embedding"]),
                                      np.float32) for d in b64["data"]])
        assert vecs.shape == (EMB_INPUTS, BE) and np.isfinite(vecs).all()
        assert np.array_equal(dec, vecs.astype(np.float32)), \
            "base64 differs from the float vectors"
        n_tok = got["usage"]["prompt_tokens"]
        assert n_tok == sum(len(i) for i in ids)
        t1 = time.perf_counter()
        cpu = _moved(eng.params, "cpu", torch.float32)
        want = cpu_pooled(lambda t, n: bert_forward(
            cpu, eng.cfg, t, n, pooling=eng.cfg.pooling), ids)
        cos = _row_cos(vecs, want)
        log(f"  /v1/embeddings: {EMB_INPUTS} inputs of "
            f"{min(map(len, ids))} to {max(map(len, ids))} tokens, {n_tok} "
            f"tokens, {ms:.1f} ms = {n_tok / ms * 1e3:.1f} tok/s (graphs "
            f"warmed, none captured); base64 = float; min cosine vs the f32 "
            f"CPU encoder {cos.min():.6f} (tol {BERT_COS}; CPU "
            f"{time.perf_counter() - t1:.1f} s)")
        assert cos.min() >= BERT_COS, cos.min()
        replay = embed_replay(eng, [i[:EMBED_KEY_T] for i in
                                    sorted(ids, key=len)[-EMBED_KEY_ROWS:]],
                              eng.cfg.pooling, flush)
        log(f"  one {tuple(replay['key'])} replay: {replay['ms']:.4f} ms "
            f"device (bound {replay['bound_ms']:.4f} ms by "
            f"{replay['bound_by']}, {replay['tflop']:.3f} TFLOP); bit-equal "
            "to the eager pass")
        return dict(n_inputs=EMB_INPUTS, tokens=n_tok, ms=ms,
                    tok_s=n_tok / ms * 1e3, min_cos=float(cos.min()),
                    graphs=eng.graphs.n_graphs,
                    graph_pool_mib=eng.graphs.pool_bytes / 2**20,
                    replay=replay)
    finally:
        srv.shutdown()
        srv.server_close()
        eng.stop()
        thread.join(timeout=30)


def _pair_ids(tok, q: str, d: str) -> list:
    """The route's [CLS|BOS] q [SEP] d [SEP] [EOS] (server/http.rerank)."""
    q_ids = tok.encode(q, add_special=False)
    d_ids = tok.encode(d, add_special=False)
    bos = [tok.cls_id] if tok.cls_id is not None else (
        [tok.bos_id] if tok.bos_id is not None else [])
    sep = [tok.sep_id] if tok.sep_id is not None else (
        [tok.eos_id] if tok.eos_id is not None else [])
    eos = [] if tok.sep_id is not None and tok.eos_id is None else (
        [tok.eos_id] if tok.eos_id is not None else [])
    return bos + q_ids + sep + d_ids + sep + eos


def bert_rerank_phase(dev, seed, tmp) -> dict:
    """The cross-encoder through the CLI with --rerank: a query with
    RERANK_DOCS documents, normalized and not, warmed first; the scores
    against the f32 CPU encoder's."""
    from llama_box_tpu_torch import cli
    from llama_box_tpu_torch.models.bert import bert_forward
    path = f"{tmp}/synthetic-bge-base-reranker-f16.gguf"
    t0 = time.perf_counter()
    write_bert(path, seed, rank=True)
    eng, srv = cli.build_server(["-m", path, "--port", "0", "--device",
                                 dev.type, "--embeddings", "--rerank"])
    os.remove(path)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    log(f"  bge-base-width cross-encoder (pooling {eng.cfg.pooling}): "
        f"written and served in {time.perf_counter() - t0:.1f} s")
    try:
        tok = eng.tokenizer
        rng = np.random.default_rng(seed + 73)
        query = make_text(tok, rng, 16)
        docs = [make_text(tok, rng, int(n)) for n in
                rng.integers(RERANK_LENS[0], RERANK_LENS[1] + 1,
                             RERANK_DOCS)]
        bodies = {norm: {"query": query, "documents": docs,
                         "normalize": norm, "top_n": RERANK_DOCS}
                  for norm in (True, False)}
        for _ in range(2):
            for b in bodies.values():
                _post_ok(url + "/v1/rerank", b)
        n_graphs, seen = eng.graphs.n_graphs, set(eng.graphs._seen)
        res = {norm: _post_ok(url + "/v1/rerank", b)
               for norm, b in bodies.items()}
        assert eng.graphs.n_graphs == n_graphs and \
            eng.graphs._seen == seen, "a graph was captured in phase 10"
        scores = {norm: np.zeros(RERANK_DOCS) for norm in bodies}
        for norm, (b, _) in res.items():
            assert len(b["results"]) == RERANK_DOCS
            for r in b["results"]:
                scores[norm][r["index"]] = r["relevance_score"]
        pairs = [_pair_ids(tok, query, d) for d in docs] \
            + [_pair_ids(tok, query, query), _pair_ids(tok, query, "unknown")]
        cpu = _moved(eng.params, "cpu", torch.float32)
        want = cpu_pooled(lambda t, n: bert_forward(cpu, eng.cfg, t, n,
                                                    pooling="rank"), pairs)
        raw_err = float(np.abs(scores[False] - want[:RERANK_DOCS]).max())
        lo = min(want[-1], want[:RERANK_DOCS].min())
        hi = max(want[-2], want[:RERANK_DOCS].max())
        want_norm = (want[:RERANK_DOCS] - lo) / max(hi - lo, 1e-6)
        norm_err = float(np.abs(scores[True] - want_norm).max())
        top_got = list(np.argsort(-scores[False], kind="stable")[:5])
        top_want = list(np.argsort(-want[:RERANK_DOCS], kind="stable")[:5])
        for g, w_ in zip(top_got, top_want):
            assert g == w_ or abs(want[g] - want[w_]) <= 2 * RERANK_ATOL, \
                (top_got, top_want)
        ms = res[True][1]
        log(f"  /v1/rerank: {RERANK_DOCS} documents of "
            f"{min(map(len, pairs))} to {max(map(len, pairs))} pair tokens, "
            f"{ms:.1f} ms = {RERANK_DOCS / ms * 1e3:.1f} docs/s normalized "
            f"({res[False][1]:.1f} ms raw); raw score max err vs the f32 CPU "
            f"encoder {raw_err:.4f} (tol {RERANK_ATOL}; scores in "
            f"[{want.min():.3f}, {want.max():.3f}]), normalized max err "
            f"{norm_err:.4f} (tol {2 * RERANK_ATOL / (hi - lo):.4f}); top 5 "
            f"{top_got} (CPU {top_want})")
        assert raw_err <= RERANK_ATOL, raw_err
        assert norm_err <= 2 * RERANK_ATOL / (hi - lo), norm_err
        return dict(n_docs=RERANK_DOCS, ms=ms, docs_s=RERANK_DOCS / ms * 1e3,
                    ms_raw=res[False][1], raw_max_err=raw_err,
                    norm_max_err=norm_err, top5=[int(x) for x in top_got],
                    top5_cpu=[int(x) for x in top_want])
    finally:
        srv.shutdown()
        srv.server_close()
        eng.stop()
        thread.join(timeout=30)


def _chat_wave(url, texts, embed_body=None, eng=None, counters=None):
    """LLAMA_CHATS greedy chats at once; with `embed_body`, one
    /v1/embeddings request sent once every chat decodes, the kernel counts
    from 0 around it (set from this thread while the engine runs: every
    key the wave meets is captured first, since a capture takes back the
    launches it made from the counts it found before it). Returns (chat
    contents, {embed response, its ms, launches, whether a chat still
    decoded when it returned})."""
    def chat(t):
        b, _ = _post_ok(url + "/v1/chat/completions", dict(
            messages=[{"role": "user", "content": t}],
            max_tokens=LLAMA_CHAT_TOKENS, temperature=0, ignore_eos=True))
        assert b["usage"]["completion_tokens"] == LLAMA_CHAT_TOKENS
        return b["choices"][0]["message"]["content"]
    result = {}

    def embed():
        deadline = time.monotonic() + 120
        while sum(s.state == "decode" for s in eng.slots) < LLAMA_CHATS:
            assert time.monotonic() < deadline, "the chats never decoded"
            time.sleep(0.002)
        for fn in counters.values():
            fn.launches = 0
        result["body"], result["ms"] = _post_ok(url + "/v1/embeddings",
                                                embed_body)
        result["launches"] = {k: fn.launches for k, fn in counters.items()}
        result["mid_decode"] = any(s.state == "decode" for s in eng.slots)
    fns = [lambda t=t: chat(t) for t in texts]
    if embed_body is not None:
        fns.append(embed)
    out = concurrently(fns)
    return out[:len(texts)], result


def llama_embed_phase(dev, seed, engine, app, flush) -> dict:
    """The bf16 path's model (its weights as served): LLAMA_CHATS greedy
    chats at -np 4, alone and with a LLAMA_EMB_INPUTS-input embeddings
    request arriving mid-decode (fresh engines, graphs, pipelined); the
    vectors against the f32 CPU forward_embeddings."""
    from llama_box_tpu_torch.models.llama import forward_embeddings, make_rope
    counters = kernel_counters()
    tok = engine.tokenizer
    rng = np.random.default_rng(seed + 79)
    chats = [make_prompt(tok, rng, 480) for _ in range(LLAMA_CHATS)]
    texts = [make_text(tok, rng, int(n)) for n in
             rng.integers(LLAMA_EMB_LENS[0], LLAMA_EMB_LENS[1] + 1,
                          LLAMA_EMB_INPUTS)]
    ids = [tok.encode(t) for t in texts]
    body = {"input": texts}
    runs = {}
    for label in ("alone", "beside"):
        eng = _spec_engine(engine, None, engine.ecfg)
        if label == "beside":
            warm_every_key(eng)         # the chats' keys
        eng.start()
        url, close = _serve_engine(app, eng)
        try:
            if label == "beside":
                for _ in range(2):      # the embed keys: eager, capture
                    _post_ok(url + "/v1/embeddings", body)
                n_graphs, seen = eng.graphs.n_graphs, set(eng.graphs._seen)
            runs[label] = _chat_wave(
                url, chats, body if label == "beside" else None, eng,
                counters)
            if label == "beside":
                assert eng.graphs.n_graphs == n_graphs and \
                    eng.graphs._seen == seen, \
                    "a graph was captured in phase 10's chats"
                lists = [i[:EMBED_KEY_T] for i in ids[:EMBED_KEY_ROWS]]
                lists = [(li * (EMBED_KEY_T // len(li) + 1))[:EMBED_KEY_T]
                         for li in lists]
                replay = embed_replay(eng, lists, "mean", flush)
        finally:
            close()
    same = runs["alone"][0] == runs["beside"][0]
    r = runs["beside"][1]
    vecs = np.array([d["embedding"] for d in r["body"]["data"]])
    n_tok = r["body"]["usage"]["prompt_tokens"]
    cfg = engine.cfg
    cpu = _moved(engine.params, "cpu", torch.float32)
    cos_t, sin_t = make_rope(cfg, LLAMA_EMB_LENS[1] + 8, device="cpu")
    t1 = time.perf_counter()
    want = cpu_pooled(lambda t, n: forward_embeddings(
        cpu, cfg, t, n, cos_t, sin_t, pooling="mean"), ids)
    cos = _row_cos(vecs, want)
    log(f"  {LLAMA_CHATS} greedy chats ({LLAMA_CHAT_TOKENS} tokens) with a "
        f"{LLAMA_EMB_INPUTS}-input /v1/embeddings request mid-decode "
        f"({n_tok} tokens, {r['ms']:.1f} ms = {n_tok / r['ms'] * 1e3:.1f} "
        f"tok/s; a chat still decoding at its end: {r['mid_decode']}): "
        f"texts {'identical to' if same else 'DIFFERENT from'} the chats "
        f"alone; min cosine vs the f32 CPU forward {cos.min():.6f} (tol "
        f"{LLAMA_COS}; CPU {time.perf_counter() - t1:.1f} s); launches in "
        f"the request {r['launches']}")
    log(f"  one {tuple(replay['key'])} replay: {replay['ms']:.4f} ms device "
        f"(bound {replay['bound_ms']:.4f} ms by {replay['bound_by']}, "
        f"{replay['tflop']:.3f} TFLOP); bit-equal to the eager pass")
    assert same, "an embed request beside the chats changed their texts"
    assert cos.min() >= LLAMA_COS, cos.min()
    assert min(r["launches"].values()) >= 0, r["launches"]
    assert r["launches"]["flash_prefill"] > 0, "no flash prefill launch"
    return dict(tokens=n_tok, ms=r["ms"], tok_s=n_tok / r["ms"] * 1e3,
                min_cos=float(cos.min()), texts_equal=same,
                mid_decode=r["mid_decode"], launches=r["launches"],
                replay=replay)


# the projection kernels an embeddings request must launch on each
# quantized path (its attention: flash prefill)
EMBED_PATH_KERNELS = {
    "w8a8": ("flash_prefill", "w8a8_matmul", "fused_norm_qmm",
             "fused_layer_tail", "row_norm"),
    "q4": ("flash_prefill", "q4_matmul", "q8_matmul", "row_norm")}


def embed_path_check(engine, url, seed, mode) -> dict:
    """Phase 10w/10q on the served quantized model: one /v1/embeddings
    request of 8 short inputs (one pass of 8 rows: more than 64 token
    rows) and one longer one (a pass of 1 row: at most 64 on w8a8, the
    fused kernels), the kernel counts from 0 around it."""
    counters = kernel_counters()
    tok = engine.tokenizer
    rng = np.random.default_rng(seed + 83)
    texts = [make_text(tok, rng, 14) for _ in range(8)] \
        + [make_text(tok, rng, 60)]
    for fn in counters.values():
        fn.launches = 0
    b, ms = _post_ok(url + "/v1/embeddings", {"input": texts})
    launches = {k: fn.launches for k, fn in counters.items()}
    vecs = np.array([d["embedding"] for d in b["data"]])
    assert vecs.shape == (9, E) and np.isfinite(vecs).all()
    assert np.allclose(np.linalg.norm(vecs, axis=1), 1.0)
    log(f"  phase 10{'w' if mode == 'w8a8' else 'q'}: /v1/embeddings of 9 "
        f"inputs ({b['usage']['prompt_tokens']} tokens) in {ms:.1f} ms; "
        f"launches {launches}")
    for k, n in launches.items():
        if k in EMBED_PATH_KERNELS[mode]:
            assert n > 0, f"{k} was never launched by the {mode} embed pass"
        else:
            assert n == 0, f"{k} launched by the {mode} embed pass"
    return dict(ms=ms, launches=launches)


def embed_phase(dev, seed, tmp, engine, app) -> dict:
    """Phase 10 (see the module docstring)."""
    log("== phase 10: embeddings and rerank: bge-base-width BERT encoder "
        "and cross-encoder, the bf16 path's TinyLlama beside greedy chats")
    t0 = time.perf_counter()
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    out = dict(bert=bert_embed_phase(dev, seed, tmp, flush),
               rerank=bert_rerank_phase(dev, seed, tmp),
               llama=llama_embed_phase(dev, seed, engine, app, flush))
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 10: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the row-norm kernel (csrc/norm.cu): phases 3n and 4n

# label -> (x shape, style, weight groups, x dtype): the shapes the served
# paths give it (TinyLlama's and the phase 11 models' rows) and variants
NORM_CASES = {
    "rms x[4,2048] bf16 (decode rows)": ((4, E), "rms", 1, torch.bfloat16),
    "rms x[2048,2048] bf16 (a 4 x 512 prefill)": ((4 * N_UBATCH, E), "rms",
                                                  1, torch.bfloat16),
    "rms x[4,16,128] bf16 (qwen3 q norm, 4 rows)": ((4, 16, 128), "rms", 1,
                                                    torch.bfloat16),
    "ln+bias x[4,2048] bf16 (pythia decode rows)": ((4, E), "ln", 1,
                                                    torch.bfloat16),
    "ln+bias x[2048,2048] bf16 (pythia prefill)": ((4 * N_UBATCH, E), "ln",
                                                   1, torch.bfloat16),
    "ln per head x[4,16,128] bf16 (chameleon)": ((4, 16, 128), "ln", 16,
                                                 torch.bfloat16),
    "rms x[9,100] bf16 (an odd width)": ((9, 100), "rms", 1, torch.bfloat16),
    "ln+bias x[4,6144] f32 (an FF row)": ((4, 6144), "ln", 1, torch.float32),
}
# timed cases, and the one the kernels line reports
NORM_TIMED = ("rms x[4,2048] bf16 (decode rows)",
              "rms x[2048,2048] bf16 (a 4 x 512 prefill)",
              "rms x[4,16,128] bf16 (qwen3 q norm, 4 rows)",
              "ln+bias x[2048,2048] bf16 (pythia prefill)")
# float32 outside the tensor cores (the norm's few operations an element)
F32_FLOPS = 67e12


def _norm_inputs(g, dev, shape, style, groups, dt):
    n = shape[-1]
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.3).to(dt)
    w = (1 + 0.1 * torch.randn(groups * n, generator=g, device=dev)).to(
        torch.bfloat16)
    b = None if style != "ln" else (0.1 * torch.randn(
        groups * n, generator=g, device=dev)).to(torch.bfloat16)
    return x, w, b


def _norm_fns(x, w, b, style, groups):
    """(kernel call, plain call, one library call or None) of a case."""
    from llama_box_tpu_torch.ops import norm as nm
    F = torch.nn.functional
    n = x.shape[-1]
    if groups > 1:
        return (lambda: nm.ln_per_head(x, w, b),
                lambda: nm.ln_per_head_plain(x, w, b), None)
    if style == "ln":
        lib = lambda: F.layer_norm(x, (n,), w.to(x.dtype), b.to(x.dtype),
                                   1e-6)
    else:
        lib = lambda: F.rms_norm(x, (n,), w.to(x.dtype), 1e-6)
    return (lambda: nm.norm_any(x, w, b, style, 1e-6),
            lambda: nm.norm_any_plain(x, w, b, style, 1e-6), lib)


def norm_kernel_phase(dev, seed):
    """Phase 3n: the row-norm kernel against its plain version (within
    one bf16 rounding, rtol 2**-7; f32 within 1e-5 relative: the sums run
    in another order); a row's bits the same alone, among 4 rows and among
    36 (a verify pass of 4 slots x 9 rows). Phase 4n: its device times
    beside the bound (each input read once, the output written once; bytes
    bound it), the plain version and torch's rms_norm / layer_norm (never
    used by the port)."""
    from llama_box_tpu_torch.ops import norm as nm
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 17)
    log("== phase 3n: the row-norm kernel (csrc/norm.cu) vs plain")
    err, cases = 0.0, {}
    for label, (shape, style, groups, dt) in NORM_CASES.items():
        x, w, b = _norm_inputs(g, dev, shape, style, groups, dt)
        kern, plain, lib = _norm_fns(x, w, b, style, groups)
        before = nm.row_norm.launches
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert nm.row_norm.launches == before + 1, "one launch a call"
        assert got.dtype == dt and torch.isfinite(got).all(), label
        d = (got.float() - want.float()).abs()
        rel = 2 ** -7 if dt == torch.bfloat16 else 1e-5
        bad = int((d > rel * want.float().abs() + 1e-5).sum())
        e = float(d.max())
        log(f"  row_norm {label:<46s} max_abs_err {e:.3e}  (tol "
            f"{rel:g} x |plain| + 1e-5; {bad} outside)")
        assert bad == 0, label
        err = max(err, e)
        cases[label] = (x, w, b, style, groups)
    for n, style in ((E, "rms"), (E, "ln"), (128, "rms"), (6144, "ln")):
        x, w, b = _norm_inputs(g, dev, (36, n), style, 1, torch.bfloat16)
        full = nm.norm_any(x, w, b, style, 1e-6)
        same = torch.equal(full[8:12], nm.norm_any(x[8:12], w, b, style,
                                                   1e-6))
        for i in (0, 13, 35):
            same &= torch.equal(full[i:i + 1],
                                nm.norm_any(x[i:i + 1], w, b, style, 1e-6))
        log(f"  row_norm {style} n={n}: a row's bits alone = among 4 = "
            f"among 36: {same}")
        assert same, (n, style)

    log("== phase 4n: row_norm device times (median of 15, a plain "
        "version's of 5, cold L2)")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for label in NORM_TIMED:
        x, w, b, style, groups = cases[label]
        kern, plain, lib = _norm_fns(x, w, b, style, groups)
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * 2 \
            + (0 if b is None else b.numel() * 2)
        flops = x.numel() * (7 if style == "ln" else 4)
        b_ms, b_by = bound_ms(nbytes, flops, F32_FLOPS)
        r = dict(kind="row_norm", case=label, ms=device_ms(kern, flush),
                 plain_ms=device_ms(plain, flush, n=PLAIN_REPS),
                 library_ms=None if lib is None else device_ms(lib, flush),
                 bound_ms=b_ms, bound_by=b_by, mbytes=nbytes / 1e6)
        rows.append(r)
        log("  " + json.dumps(r))
    return {"row_norm": err}, rows


# ---------------------------------------------------------------------------
# the routed-expert kernel (csrc/moe_ffn.cu): phases 3m and 4m

# label -> (N rows, X experts, K picks, E, F, activation, gpt-oss's biases,
# an expert no row picks): Qwen3-30B-A3B's layer at the rows phase 13 gives
# it, and gpt-oss-20b's (32 experts, 4 a token, 2880 wide) with biases
MOE_CASES = {
    "qwen3-30b-a3b N 4 (a decode step)": (4, 128, 8, 2048, 768, "silu",
                                          False, False),
    "qwen3-30b-a3b N 36 (a verify pass)": (36, 128, 8, 2048, 768, "silu",
                                           False, False),
    "qwen3-30b-a3b N 2048 (a 4 x 512 prefill)": (2048, 128, 8, 2048, 768,
                                                 "silu", False, False),
    "gpt-oss-20b N 36, swiglu_oai, biases, an idle expert": (
        36, 32, 4, 2880, 2880, "swiglu_oai", True, True),
}
MOE_MAIN = "qwen3-30b-a3b N 4 (a decode step)"
# x max|plain|: f32 sums of the same exact bf16 products in another order;
# the activation enters the down product as hi + lo bf16 parts
MOE_RTOL = 1e-4


def _moe_inputs(g, dev, case):
    N, X, K, E, F, act, bias, idle = MOE_CASES[case]
    bf = torch.bfloat16

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(bf)
    pool = X - 1 if idle else X
    topi = torch.rand(N, pool, generator=g, device=dev).argsort(dim=1)[
        :, :K].to(torch.int32)
    topv = torch.rand(N, K, generator=g, device=dev) + 0.05
    stacks = (r(X, E, F, s=E ** -0.5), r(X, E, F, s=E ** -0.5),
              r(X, F, E, s=F ** -0.5))
    kw = dict(act=act)
    if bias:
        kw.update(b_gate=r(X, F, s=0.5), b_up=r(X, F, s=0.5),
                  b_down=r(X, E, s=0.1))
    return r(N, E), topi, topv, stacks, kw


def moe_work(h, topi, stacks, kw) -> tuple[float, float]:
    """(bytes, operations) one call needs: the distinct experts' stacks
    its rows pick (and their biases), h, the picks and y, each once; the
    three products of every (row, pick) pair."""
    N, E = h.shape
    K = topi.shape[1]
    F = stacks[0].shape[-1]
    used = int(torch.unique(topi).numel())
    nbytes = used * 3 * E * F * 2 + N * E * 2 + N * K * 8 + N * E * 4
    if kw.get("b_gate") is not None:
        nbytes += used * (2 * F + E) * 2
    return nbytes, 2.0 * N * K * 3 * E * F


def _grouped_mm_fn(h, topi, stacks, act):
    """The library yardstick, never used by the port: torch._grouped_mm's
    gate, up and down products over the rows sorted by expert beforehand
    (the sort and the weighted sum are not in it), the activation between
    them: (the call, ""), or (None, why) where the card's torch lacks it
    or refuses the shapes."""
    from llama_box_tpu_torch.ops.moe import expert_act
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch has no _grouped_mm"
    K = topi.shape[1]
    flat = topi.reshape(-1).long()
    order = torch.sort(flat, stable=True).indices
    rows = h.index_select(0, order // K).contiguous()
    offs = torch.bincount(flat, minlength=stacks[0].shape[0]).cumsum(0).to(
        torch.int32)
    wg, wu, wd = stacks

    def fn():
        gate = torch._grouped_mm(rows, wg, offs=offs)
        up = torch._grouped_mm(rows, wu, offs=offs)
        a = expert_act(gate.float(), up.float(), act).to(torch.bfloat16)
        return torch._grouped_mm(a, wd, offs=offs)
    try:
        fn()
        torch.cuda.synchronize()
    except Exception as exc:   # the yardstick only: its absence is logged
        return None, f"{type(exc).__name__}: {str(exc)[:160]}"
    return fn, ""


def moe_kernel_phase(dev, seed):
    """Phase 3m: the routed-expert kernel against its plain version at the
    rows phase 13 gives it (Qwen3-30B-A3B's layer: a decode step of 4
    rows, a verify pass of 36, a 4 x 512 prefill) and at gpt-oss-20b's
    widths with swiglu_oai, biases and an expert no row picks, within
    MOE_RTOL x max|plain|; output guards of NaN stay NaN; a row's bits the
    same alone, among 36 and among 2048. Phase 4m: its device times beside
    the bound (the distinct experts' bytes, or the pairs' operations), the
    plain version and torch._grouped_mm (never used by the port)."""
    from llama_box_tpu_torch.ops.moe import moe_ffn, moe_ffn_plain
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 23)
    log("== phase 3m: the routed-expert kernel (csrc/moe_ffn.cu) vs plain")
    err, cases = 0.0, {}
    pad = 256
    for label in MOE_CASES:
        h, topi, topv, stacks, kw = _moe_inputs(g, dev, label)
        N, E = h.shape
        buf = torch.full((N * E + 2 * pad,), float("nan"), device=dev)
        out = buf[pad:pad + N * E].view(N, E)
        before = moe_ffn.launches
        got = moe_ffn(h, topi, topv, *stacks, out=out, **kw)
        want = moe_ffn_plain(h, topi, topv, *stacks, **kw)
        torch.cuda.synchronize()
        assert moe_ffn.launches == before + 1
        assert torch.isnan(buf[:pad]).all() and torch.isnan(buf[-pad:]).all(), \
            f"{label}: an output guard was written"
        assert torch.isfinite(got).all(), label
        e = float((got - want).abs().max())
        tol = MOE_RTOL * float(want.abs().max())
        log(f"  moe_ffn {label:<56s} max_abs_err {e:.3e} (tol {tol:.3e}; "
            f"{int(torch.unique(topi).numel())} experts picked)")
        assert e <= tol, label
        err = max(err, e)
        cases[label] = (h, topi, topv, stacks, kw)
    h, topi, topv, stacks, kw = cases["qwen3-30b-a3b N 2048 (a 4 x 512 "
                                      "prefill)"]
    full = moe_ffn(h, topi, topv, *stacks, **kw)
    some = moe_ffn(h[:36], topi[:36], topv[:36], *stacks, **kw)
    same = torch.equal(full[:36], some)
    for i in (0, 7, 35):
        same &= torch.equal(full[i:i + 1], moe_ffn(
            h[i:i + 1], topi[i:i + 1], topv[i:i + 1], *stacks, **kw))
    log(f"  moe_ffn: a row's bits alone = among 36 = among 2048: {same}")
    assert same

    log("== phase 4m: moe_ffn device times (median of 15, a plain "
        "version's of 5, cold L2)")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for label, (h, topi, topv, stacks, kw) in cases.items():
        nbytes, flops = moe_work(h, topi, stacks, kw)
        b_ms, b_by = bound_ms(nbytes, flops)
        lib, why = _grouped_mm_fn(h, topi, stacks, kw["act"])
        r = dict(kind="moe_ffn", case=label,
                 ms=device_ms(lambda: moe_ffn(h, topi, topv, *stacks, **kw),
                              flush),
                 plain_ms=device_ms(lambda: moe_ffn_plain(
                     h, topi, topv, *stacks, **kw), flush, n=PLAIN_REPS),
                 library_ms=None if lib is None else device_ms(lib, flush),
                 bound_ms=b_ms, bound_by=b_by, mbytes=nbytes / 1e6,
                 gflop=flops / 1e9)
        if why:
            r["library_note"] = why
        rows.append(r)
        log("  " + json.dumps(r))
    return {"moe_ffn": err}, rows


# ---------------------------------------------------------------------------
# phase 11: the dense llama variants at published widths

# name -> the published config's widths (every layer; the vocabulary a
# synthetic one of the published size)
VARIANTS = {
    # Qwen/Qwen3-1.7B config.json: RMS, per-head q/k RMS norms, tied
    # embeddings, GQA 2; depth cut from 28 to 4 layers (the script's time
    # limit, with phase 12 beside it)
    "qwen3-1.7b": dict(arch="qwen3", L=4, E=2048, H=16, HKV=8, D=128,
                       FF=6144, V=151936, rot=128, eps=1e-6, base=1e6,
                       ctx=40960),
    # EleutherAI/pythia-1.4b config.json (gpt_neox): LayerNorm with
    # biases, parallel residual, fused biased qkv, rotary_pct 0.25,
    # ungated GELU FFN with biases, untied output; depth cut from 24 to 4
    "pythia-1.4b": dict(arch="gptneox", L=4, E=2048, H=16, HKV=16, D=128,
                        FF=8192, V=50304, rot=32, eps=1e-5, base=10000.0,
                        ctx=2048),
}
# phase 12: the attention variants at published widths; depth cut (for
# the script's time limit with phases 13 to 15 beside it) to one of
# Gemma-3-1B's 6-layer local/global patterns and 4 of BLOOM-560m's layers
ATTN_VARIANTS = {
    # google/gemma-3-1b-pt config.json: 26 x 1152, 4 / 1 heads of 256, FF
    # 6912, vocab 262144, sliding window 512 on 5 layers of 6, rope bases
    # 1e6 (global) and 1e4 (local), per-head q/k RMS norms, post norms,
    # GELU-gated FFN, embeddings scaled by sqrt(1152) and tied; 6 of 26
    # layers
    "gemma3-1b": dict(arch="gemma3", L=6, E=1152, H=4, HKV=1, D=256,
                      FF=6912, V=262144, rot=256, eps=1e-6, base=1e6,
                      ctx=32768, window=512),
    # bigscience/bloom-560m config.json: 24 x 1024, 16 heads of 64 (MHA),
    # FF 4096, vocab 250880, ALiBi (no rotary), embedding LayerNorm,
    # LayerNorms and projections with biases, fused qkv, tied embeddings;
    # 4 of 24 layers
    "bloom-560m": dict(arch="bloom", L=4, E=1024, H=16, HKV=16, D=64,
                       FF=4096, V=250880, rot=64, eps=1e-5, base=10000.0,
                       ctx=2048),
}
# phase 13: a mixture-of-experts model at published widths
MOE_VARIANTS = {
    # Qwen/Qwen3-30B-A3B config.json: 48 x 2048, 32 / 4 heads of 128,
    # per-head q/k RMS norms, 128 experts, 8 a token, expert FF 768
    # (moe_intermediate_size; intermediate_size 6144), norm_topk_prob,
    # rope base 1e6, vocab 151936, untied output; depth cut from 48 to 4
    # layers (the script's time limit)
    "qwen3-30b-a3b": dict(arch="qwen3moe", L=4, E=2048, H=32, HKV=4, D=128,
                          FF=6144, FFE=768, X=128, K=8, V=151936, rot=128,
                          eps=1e-6, base=1e6, ctx=40960),
}
# phase 14: multi-head latent attention at published widths
MLA_VARIANTS = {
    # deepseek-ai/DeepSeek-V2-Lite config.json: 27 x 2048, 16 heads,
    # q_lora_rank null (a plain wq), kv_lora_rank 512, qk nope 128 + rope
    # 64, v_head_dim 128; the first layer dense (FF 10944), the rest MoE:
    # 64 experts, 6 a token, moe_intermediate_size 1408, 2 shared experts
    # (one shexp of FF 2816), softmax scores, norm_topk_prob false,
    # routed_scaling_factor 1.0; rope_theta 1e4 with YaRN (factor 40,
    # original context 4096; mscale_all_dim 0.707 as the GGUF's
    # yarn_log_multiplier 0.0707), rms eps 1e-6, vocab 102400, untied;
    # depth cut from 27 to 4 layers (1 dense + 3 MoE)
    "deepseek-v2-lite": dict(arch="deepseek2", L=4, E=2048, H=16, HKV=16,
                             D=192, DV=128, rot=64, QLORA=0, KVLORA=512,
                             FF=10944, FFE=1408, X=64, K=6, SHEXP=2,
                             V=102400, eps=1e-6, base=10000.0, ctx=163840),
    # openbmb/MiniCPM3-4B config.json: 62 x 2560, 40 heads, q_lora_rank
    # 768, kv_lora_rank 256, qk nope 64 + rope 32, v_head_dim 64 (hidden /
    # heads), FF 6400, vocab 73448, scale_emb 12, scale_depth 1.4 (the
    # residual scale 1.4 / sqrt(62)), dim_model_base 256 (logits x 256 /
    # 2560), longrope (16 factors a set, made from the seed: the published
    # ones are not in the repo), rms eps 1e-5, untied; depth cut from 62 to
    # 4 layers
    "minicpm3-4b": dict(arch="minicpm3", L=4, E=2560, H=40, HKV=40, D=96,
                        DV=64, rot=32, QLORA=768, KVLORA=256, FF=6400,
                        V=73448, eps=1e-5, base=10000.0, ctx=32768),
}
VARIANT_PROMPT, VARIANT_TOKENS = 200, 64
VARIANT_COS = 0.99


def _q8_random(rng, shape, std=0.02) -> bytes:
    """A Q8_0 tensor of uniform random codes (std `std`) in its block
    layout (an f16 scale, then 32 int8 codes): written directly, as
    quantizing a billion floats in numpy would take a minute."""
    n = int(np.prod(shape))
    blocks = np.empty((n // 32, 34), np.uint8)
    d = np.float16(std * 3 ** 0.5 / 127)
    blocks[:, 0:2] = np.frombuffer(d.tobytes(), np.uint8)
    blocks[:, 2:] = rng.integers(-127, 128, (n // 32, 32),
                                 dtype=np.int8).view(np.uint8)
    return blocks.tobytes()


def write_variant(path: str, name: str, seed: int,
                  n_layers: int | None = None) -> None:
    """The synthetic GGUF of VARIANTS[name] (or ATTN_VARIANTS',
    MOE_VARIANTS', MLA_VARIANTS', FAMILY_VARIANTS'): Q8_0 matrices (the
    expert stacks too), F32 vectors and the MoE routers in F32 (as
    llama.cpp's converter writes them), random from `seed`, a synthetic
    vocabulary of the published size and the chatml template; n_layers in
    place of the config's depth where given."""
    from llama_box_tpu_torch.gguf import GGMLType, GGUFWriter
    c = {**VARIANTS, **ATTN_VARIANTS, **MOE_VARIANTS, **MLA_VARIANTS,
         **MM_VARIANTS, **FAMILY_VARIANTS}[name]
    a, L_, E_, H_, HKV_, D_, FF_, V_ = (c[k] for k in (
        "arch", "L", "E", "H", "HKV", "D", "FF", "V"))
    L_ = n_layers or L_
    rng = np.random.default_rng(seed + 111)
    vocab, scores, types = spm_vocab(V_)
    w = GGUFWriter(path, architecture=a)
    for k, v in ((f"{a}.block_count", L_), (f"{a}.context_length", c["ctx"]),
                 (f"{a}.embedding_length", E_),
                 (f"{a}.feed_forward_length", FF_),
                 (f"{a}.attention.head_count", H_),
                 (f"{a}.attention.head_count_kv", HKV_),
                 (f"{a}.attention.layer_norm_rms_epsilon", c["eps"]),
                 (f"{a}.attention.layer_norm_epsilon", c["eps"]),
                 (f"{a}.rope.freq_base", c["base"]),
                 (f"{a}.rope.dimension_count", c["rot"]),
                 (f"{a}.vocab_size", V_),
                 ("general.name", f"synthetic-{name}"),
                 ("tokenizer.ggml.model", "llama"),
                 ("tokenizer.ggml.tokens", vocab),
                 ("tokenizer.ggml.scores", np.asarray(scores, np.float32)),
                 ("tokenizer.ggml.token_type", np.asarray(types, np.int32)),
                 ("tokenizer.ggml.bos_token_id", 1),
                 ("tokenizer.ggml.eos_token_id", 2),
                 ("tokenizer.ggml.unknown_token_id", 0),
                 ("tokenizer.ggml.add_bos_token", True),
                 ("tokenizer.chat_template", CHATML)):
        w.add_kv(k, v)
    if a == "gptneox":
        w.add_kv(f"{a}.use_parallel_residual", True)
    if a == "openelm":
        # the per-layer arrays after the scalars: a reader keeps the last
        for k, v in (("attention.head_count", c["hc"]),
                     ("attention.head_count_kv", c["hk"]),
                     ("feed_forward_length", c["ffs"]),
                     ("attention.key_length", D_)):
            w.add_kv(f"{a}.{k}", v)
    if a == "jetmoe":
        for k, v in (("expert_count", c["X"]), ("expert_used_count", c["K"]),
                     ("attention.key_length", D_),
                     ("attention.value_length", D_)):
            w.add_kv(f"{a}.{k}", v)
    if "sections" in c:
        w.add_kv(f"{a}.rope.dimension_sections",
                 np.asarray(c["sections"], np.int32))
    if a == "qwen3moe":
        for k, v in (("expert_count", c["X"]), ("expert_used_count", c["K"]),
                     ("expert_feed_forward_length", c["FFE"]),
                     ("attention.key_length", D_),
                     ("attention.value_length", D_)):
            w.add_kv(f"{a}.{k}", v)
    if "KVLORA" in c:
        for k, v in (("attention.key_length", D_),
                     ("attention.value_length", c["DV"]),
                     ("attention.q_lora_rank", c["QLORA"]),
                     ("attention.kv_lora_rank", c["KVLORA"])):
            w.add_kv(f"{a}.{k}", v)
    if a == "deepseek2":
        for k, v in (("expert_count", c["X"]), ("expert_used_count", c["K"]),
                     ("expert_feed_forward_length", c["FFE"]),
                     ("expert_shared_count", c["SHEXP"]),
                     ("expert_weights_scale", 1.0),
                     ("expert_weights_norm", False),
                     ("expert_gating_func", 1),
                     ("leading_dense_block_count", 1),
                     ("rope.scaling.type", "yarn"),
                     ("rope.scaling.factor", 40.0),
                     ("rope.scaling.original_context_length", 4096),
                     ("rope.scaling.yarn_log_multiplier", 0.0707)):
            w.add_kv(f"{a}.{k}", v)
    if a == "minicpm3":
        for k, v in (("embedding_scale", 12.0),
                     ("residual_scale", 1.4 / 62 ** 0.5),
                     ("logit_scale", 256 / 2560)):
            w.add_kv(f"{a}.{k}", v)
    if a == "gemma3":
        for k, v in (("attention.key_length", D_),
                     ("attention.value_length", D_),
                     ("attention.sliding_window", c["window"]),
                     ("attention.sliding_window_pattern", 6),
                     ("rope.local_freq_base", 10000.0)):
            w.add_kv(f"{a}.{k}", v)
    q8 = GGMLType.Q8_0
    ln = a in ("gptneox", "bloom")

    def mat(tname, *shape):
        w.add_raw_tensor(tname, shape, q8, _q8_random(rng, shape))

    def vec(tname, n, one=False):
        x = rng.standard_normal(n, dtype=np.float32) * 0.02
        w.add_tensor(tname, x + 1.0 if one else x)

    mat("token_embd.weight", V_, E_)
    if a == "bloom":
        vec("token_embd_norm.weight", E_, one=True)
        vec("token_embd_norm.bias", E_)
    vec("output_norm.weight", E_, one=True)
    if ln:
        vec("output_norm.bias", E_)
    if a in ("gptneox", "qwen3moe", "deepseek2", "minicpm3", "llama",
             "qwen2", "jetmoe"):
        # qwen3, gemma3, bloom and qwen2vl tie theirs
        mat("output.weight", V_, E_)
    if a == "minicpm3":
        for t in ("long", "short"):
            w.add_tensor(f"rope_factors_{t}.weight", (1.0 + rng.uniform(
                0.0, 2.0, c["rot"] // 2)).astype(np.float32))
    qd, kvd = H_ * D_, HKV_ * D_
    for i in range(L_):
        p = f"blk.{i}."
        vec(p + "attn_norm.weight", E_, one=True)
        vec(p + "ffn_norm.weight", E_, one=True)
        if a == "gemma3":
            vec(p + "post_attention_norm.weight", E_, one=True)
            vec(p + "post_ffw_norm.weight", E_, one=True)
        if ln:
            vec(p + "attn_norm.bias", E_)
            vec(p + "ffn_norm.bias", E_)
            mat(p + "attn_qkv.weight", qd + 2 * kvd, E_)
            vec(p + "attn_qkv.bias", qd + 2 * kvd)
            mat(p + "attn_output.weight", E_, qd)
            vec(p + "attn_output.bias", E_)
            mat(p + "ffn_up.weight", FF_, E_)
            vec(p + "ffn_up.bias", FF_)
            mat(p + "ffn_down.weight", E_, FF_)
            vec(p + "ffn_down.bias", E_)
        elif a == "openelm":
            # the layer's own head counts and FFN width, a fused qkv
            hq, hk, ff = c["hc"][i], c["hk"][i], c["ffs"][i]
            mat(p + "attn_qkv.weight", (hq + 2 * hk) * D_, E_)
            mat(p + "attn_output.weight", E_, hq * D_)
            vec(p + "attn_q_norm.weight", D_, one=True)
            vec(p + "attn_k_norm.weight", D_, one=True)
            mat(p + "ffn_gate.weight", ff, E_)
            mat(p + "ffn_up.weight", ff, E_)
            mat(p + "ffn_down.weight", E_, ff)
        elif a == "jetmoe":
            # mixture of attention: q and output experts over the shared k
            # and v, a router, the output bias; then the FFN's experts
            X_ = c["X"]
            mat(p + "attn_q_exps.weight", X_, kvd, E_)
            mat(p + "attn_output_exps.weight", X_, E_, kvd)
            mat(p + "attn_k.weight", kvd, E_)
            mat(p + "attn_v.weight", kvd, E_)
            vec(p + "attn_output.bias", E_)
            for r in ("attn_gate_inp", "ffn_gate_inp"):
                w.add_tensor(p + f"{r}.weight", rng.standard_normal(
                    (X_, E_), dtype=np.float32) * 0.02)
            mat(p + "ffn_gate_exps.weight", X_, FF_, E_)
            mat(p + "ffn_up_exps.weight", X_, FF_, E_)
            mat(p + "ffn_down_exps.weight", X_, E_, FF_)
            vec(p + "ffn_down.bias", E_)
        elif "KVLORA" in c:
            # multi-head latent attention: q (low rank, or a plain wq), kv
            # low rank with its shared rope part, H heads of V
            qr, kvr, rot = c["QLORA"], c["KVLORA"], c["rot"]
            if qr:
                mat(p + "attn_q_a.weight", qr, E_)
                vec(p + "attn_q_a_norm.weight", qr, one=True)
                mat(p + "attn_q_b.weight", qd, qr)
            else:
                mat(p + "attn_q.weight", qd, E_)
            mat(p + "attn_kv_a_mqa.weight", kvr + rot, E_)
            vec(p + "attn_kv_a_norm.weight", kvr, one=True)
            mat(p + "attn_kv_b.weight", H_ * (D_ - rot + c["DV"]), kvr)
            mat(p + "attn_output.weight", E_, H_ * c["DV"])
            if a == "deepseek2" and i > 0:
                X_, FE = c["X"], c["FFE"]
                FS = FE * c["SHEXP"]
                w.add_tensor(p + "ffn_gate_inp.weight", rng.standard_normal(
                    (X_, E_), dtype=np.float32) * 0.02)
                mat(p + "ffn_gate_exps.weight", X_, FE, E_)
                mat(p + "ffn_up_exps.weight", X_, FE, E_)
                mat(p + "ffn_down_exps.weight", X_, E_, FE)
                mat(p + "ffn_gate_shexp.weight", FS, E_)
                mat(p + "ffn_up_shexp.weight", FS, E_)
                mat(p + "ffn_down_shexp.weight", E_, FS)
                continue
            mat(p + "ffn_gate.weight", FF_, E_)
            mat(p + "ffn_up.weight", FF_, E_)
            mat(p + "ffn_down.weight", E_, FF_)
        else:
            mat(p + "attn_q.weight", qd, E_)
            mat(p + "attn_k.weight", kvd, E_)
            mat(p + "attn_v.weight", kvd, E_)
            if a in ("qwen2", "qwen2vl"):
                vec(p + "attn_q.bias", qd)
                vec(p + "attn_k.bias", kvd)
                vec(p + "attn_v.bias", kvd)
            elif a != "llama":
                vec(p + "attn_q_norm.weight", D_, one=True)
                vec(p + "attn_k_norm.weight", D_, one=True)
            mat(p + "attn_output.weight", E_, qd)
            if a == "qwen3moe":
                X_, FE = c["X"], c["FFE"]
                w.add_tensor(p + "ffn_gate_inp.weight", rng.standard_normal(
                    (X_, E_), dtype=np.float32) * 0.02)
                mat(p + "ffn_gate_exps.weight", X_, FE, E_)
                mat(p + "ffn_up_exps.weight", X_, FE, E_)
                mat(p + "ffn_down_exps.weight", X_, E_, FE)
                continue
            mat(p + "ffn_gate.weight", FF_, E_)
            mat(p + "ffn_up.weight", FF_, E_)
            mat(p + "ffn_down.weight", E_, FF_)
    w.write()


def _chats(url, texts) -> tuple[list, float]:
    """Greedy ignore_eos chats of `texts` at once (VARIANT_TOKENS each):
    their contents and the wave's wall seconds."""
    def chat(text):
        return http(url + "/v1/chat/completions", dict(
            messages=[{"role": "user", "content": text}],
            max_tokens=VARIANT_TOKENS, temperature=0, ignore_eos=True))
    t0 = time.perf_counter()
    res = concurrently([lambda t=t: chat(t) for t in texts])
    wall = time.perf_counter() - t0
    out = []
    for st, text, _ in res:
        assert st == 200, st
        b = json.loads(text)
        assert b["usage"]["completion_tokens"] == VARIANT_TOKENS, b["usage"]
        out.append(b["choices"][0]["message"]["content"])
    return out, wall


_NORM_NAMES = ("11norm_kernel", "norm_kernel<")


def step_kernels(eng, tmp) -> list:
    """Names of the kernels one decode step (a one-step chain of four
    active slots) runs, from the kernel nodes of a CUDA graph capturing
    it (its debug dump; torch.profiler sometimes reports no device
    activity in a long process)."""
    import re
    S = len(eng.slots)
    _stage_decode(eng, [400 + b for b in range(S)],
                  [300 + 10 * b for b in range(S)])
    fn = lambda: eng._decode_program(1)
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    path = f"{tmp}/decode-step.dot"
    graph.debug_dump(path)
    with open(path) as f:
        nodes = re.findall(r'label="\{(\w+)\s*\n\| \{ID \| [^|]*\| ([^\\|]+)',
                           f.read())
    os.remove(path)
    return [n for kind, n in nodes if kind == "KERNEL"]


def ops_a_layer(eng, tmp) -> dict:
    """Kernels a layer a decode step with the row-norm kernel (the port's
    norms) and with the norms' plain torch versions in its place (the
    code before the kernel), each from one captured step; the row-norm
    launches a step; and whether a torch mean reduction (a norm's, in the
    plain versions) runs in the step."""
    from llama_box_tpu_torch.models import llama
    from llama_box_tpu_torch.ops import norm as nm
    names = step_kernels(eng, tmp)
    saved = {k: getattr(llama, k) for k in ("norm_any", "rms_norm",
                                             "ln_per_head")}
    try:
        llama.norm_any = nm.norm_any_plain
        llama.rms_norm = nm.rms_norm_plain
        llama.ln_per_head = nm.ln_per_head_plain
        plain = step_kernels(eng, tmp)
    finally:
        for k, f in saved.items():
            setattr(llama, k, f)
    L_ = eng.cfg.n_layers
    return dict(
        kernels_a_step=len(names), ops_a_layer=len(names) / L_,
        ops_a_layer_plain_norms=len(plain) / L_,
        norm_launches_a_step=sum(any(t in n for t in _NORM_NAMES)
                                 for n in names),
        mean_reductions_a_step=sum("MeanOps" in n for n in names),
        mean_reductions_plain=sum("MeanOps" in n for n in plain))


# each phase 11 path: CLI flags, and the kernels one request must launch
# per model (all others: none)
VARIANT_PATHS = {
    "bf16": ([], {"qwen3-1.7b": ("row_norm", "flash_prefill",
                                 "flash_decode"),
                  "pythia-1.4b": ("row_norm", "flash_prefill",
                                  "flash_decode")}),
    "w8a8": (["--weights-dtype", "quantized"],
             {"qwen3-1.7b": ("row_norm", "flash_prefill", "flash_decode",
                             "w8a8_matmul", "fused_norm_qmm",
                             "fused_layer_tail"),
              # LayerNorm, biases and the parallel residual keep the
              # fused gates shut: every projection takes w8a8_matmul
              # (the split qkv stays dense, as in the JAX loader)
              "pythia-1.4b": ("row_norm", "flash_prefill", "flash_decode",
                              "w8a8_matmul")}),
}


def variant_serve(dev, seed, tmp, name, path, mode, ref, paths=None,
                  prompt_len=VARIANT_PROMPT, forward=None,
                  extra=None, cos_min=VARIANT_COS) -> dict:
    """One phase 11 model on one path, served by the CLI: a warm-up wave
    pair (other prompts: a key's first use runs eagerly, its second
    captures; the captures left in the measured wave are counted), the
    measured wave of 4 greedy chats with graphs and chains pipelined
    (the defaults), the same wave on a fresh eager engine behind the same
    routes (texts equal), one more request counting its kernels from 0,
    small_forward's logits (or `forward`'s) against the f32 CPU forward
    `ref` (cosine >= cos_min), and the kernels of one decode step.
    `paths` (VARIANT_PATHS by default) gives the CLI flags and the
    kernels one request must launch; prompts are about `prompt_len`
    tokens. `extra(engine, routes, counters)`, run last while the server
    is up, adds its dict to the result."""
    from llama_box_tpu_torch import cli
    from llama_box_tpu_torch.server.engine import Engine
    from llama_box_tpu_torch.server.metrics import Metrics
    flags, must = (paths or VARIANT_PATHS)[mode]
    forward = forward or small_forward
    t0 = time.perf_counter()
    engine, srv = cli.build_server([
        "-m", path, "--port", "0", "-np", str(N_SLOTS), "-c", "4096",
        "-ub", str(N_UBATCH), "--decode-chain", str(CHAIN), "--no-jinja",
        "--device", dev.type] + flags)
    load_s = time.perf_counter() - t0
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    counters = kernel_counters()
    routes = srv.RequestHandlerClass.routes
    try:
        tok = engine.tokenizer
        rng = np.random.default_rng(seed + 121)
        warm = [[make_prompt(tok, rng, prompt_len)
                 for _ in range(N_SLOTS)] for _ in range(2)]
        texts = [make_prompt(tok, rng, prompt_len)
                 for _ in range(N_SLOTS)]
        one = [make_prompt(tok, rng, prompt_len)]
        for w_texts in warm:
            _chats(url, w_texts)
        n_graphs = engine.graphs.n_graphs
        engine.metrics = Metrics()
        graphs_texts, wall = _chats(url, texts)
        m = engine.metrics.snapshot()
        captured = engine.graphs.n_graphs - n_graphs
        eager = Engine(engine.cfg, engine.params, tok, dataclasses.replace(
            engine.ecfg, cuda_graphs=False, pipeline_chain=False),
            device=str(engine.device))
        ops = ops_a_layer(eager, tmp)      # before it serves: no thread
        eager.start()
        e_url, close = _serve_engine(routes, eager)
        try:
            eager_texts, e_wall = _chats(e_url, texts)
        finally:
            close()
        same = eager_texts == graphs_texts
        for fn in counters.values():
            fn.launches = 0
        _chats(url, one)
        launches = {k: fn.launches for k, fn in counters.items()}
        got = forward(engine.params, engine.cfg, dev, torch.bfloat16)
        assert torch.isfinite(got).all()
        cos = _cosine(got, ref)
        pool_mib = engine.graphs.pool_bytes / 2**20
        more = extra(engine, routes, counters) if extra else {}
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
        thread.join(timeout=30)
    res = dict(load_s=load_s, texts_equal=same, cosine=cos,
               captured_in_wave=captured,
               launches_one_request=launches,
               decode_tok_s=m["n_decode_total"] / m["t_decode_total_ms"] * 1e3,
               prefill_tok_s=m["n_prefill_total"]
               / m["t_prefill_total_ms"] * 1e3,
               window_tok_s=N_SLOTS * VARIANT_TOKENS / wall,
               eager_window_tok_s=N_SLOTS * VARIANT_TOKENS / e_wall,
               graph_pool_mib=pool_mib, **ops, **more)
    log(f"  {name} {mode}: loaded in {load_s:.1f} s; texts graphs = eager: "
        f"{same}; cosine to the f32 CPU forward {cos:.6f} (tol "
        f"{cos_min}); {captured} captures in the measured wave; decode "
        f"tok/s {res['decode_tok_s']:.1f}, window "
        f"tok/s {res['window_tok_s']:.1f} (eager "
        f"{res['eager_window_tok_s']:.1f}); a decode step: "
        f"{ops['kernels_a_step']} kernels, {ops['ops_a_layer']:.2f} a layer "
        f"({ops['ops_a_layer_plain_norms']:.2f} with the plain norms), "
        f"{ops['norm_launches_a_step']} row_norm launches, "
        f"{ops['mean_reductions_a_step']} mean reductions "
        f"({ops['mean_reductions_plain']} with the plain norms); launches "
        f"of one request {launches}")
    assert same, f"{name} {mode}: graphs and eager texts differ"
    assert cos >= cos_min, (name, mode, cos)
    assert ops["mean_reductions_a_step"] == 0, "a norm's torch reduction"
    assert ops["norm_launches_a_step"] > 0
    for k, n in launches.items():
        if k in must[name]:
            assert n > 0, f"{k} was never launched ({name}, {mode})"
        else:
            assert n == 0, f"{k} launched ({name}, {mode})"
    return res


def file_reference(path: str, name: str, seed: int,
                   forward: str = "small") -> dict:
    """Write the synthetic GGUF of `name` (write_variant), then its f32
    forward on the host, the plain versions: small_forward, or
    long_forward for "long". A worker's job beside the served phases
    (main), or a step of its phase when run alone. Returns the path, the
    logits, the model's layers, layer groups and attention widths and the
    seconds it took."""
    from llama_box_tpu_torch.models.loader import load_model
    t0 = time.perf_counter()
    write_variant(path, name, seed)
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    fwd = long_forward if forward == "long" else small_forward
    ref = fwd(params, cfg, "cpu", torch.float32)
    return dict(path=path, ref=ref, layers=cfg.n_layers,
                groups=len(params.get("layer_groups") or [0]),
                heads=cfg.n_heads, k=cfg.head_dim, v=cfg.v_head_dim,
                seconds=time.perf_counter() - t0)


def _reference(refs, tmp, name, seed, forward="small") -> dict:
    """`name`'s file and f32 host forward: a worker's (refs[name], a
    Future, waited for here) or, without `refs`, made now."""
    if refs is not None:
        t0 = time.perf_counter()
        r = refs[name].result()
        log(f"  {name}: written and its f32 forward on the host by a "
            f"worker in {r['seconds']:.1f} s (waited for here "
            f"{time.perf_counter() - t0:.1f} s)")
        return r
    r = file_reference(f"{tmp}/synthetic-{name}-q8_0.gguf", name, seed,
                       forward)
    log(f"  {name}: written and its f32 forward on the host in "
        f"{r['seconds']:.1f} s")
    return r


def variant_phase(dev, seed, tmp, refs=None) -> dict:
    """Phase 11 (see the module docstring); `refs`: the workers' files
    and host forwards (file_reference), else made here."""
    log("== phase 11: dense llama variants at published widths: "
        + ", ".join(VARIANTS))
    t_phase = time.perf_counter()
    out = {}
    for name in VARIANTS:
        r = _reference(refs, tmp, name, seed)
        path = r["path"]
        out[name] = {mode: variant_serve(dev, seed, tmp, name, path, mode,
                                         r["ref"])
                     for mode in VARIANT_PATHS}
        os.remove(path)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 11: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: the attention variants at published widths

ATTN_PROMPT = 700        # past Gemma-3-1B's 512 window
# each phase 12 path: CLI flags, and the kernels one request must launch
ATTN_PATHS = {
    "bf16": ([], {n: ("row_norm", "flash_prefill", "flash_decode")
                  for n in ATTN_VARIANTS}),
    "w8a8": (["--weights-dtype", "quantized"],
             # gemma3's unbiased RMS q/k/v projections take the fused
             # norm-quantize-matmul at decode widths; its post norms keep
             # the fused tail shut, tied logits stay dense; bloom's
             # LayerNorms and biases keep every fused gate shut
             {"gemma3-1b": ("row_norm", "flash_prefill", "flash_decode",
                            "w8a8_matmul", "fused_norm_qmm"),
              "bloom-560m": ("row_norm", "flash_prefill", "flash_decode",
                             "w8a8_matmul")}),
}


def long_forward(params, cfg, device, kv_dtype):
    """One slot: two 320-token prefill chunks (positions 0..639, past a
    512 window, the second attending the first from the cache), then one
    decode step. Returns the logits [3, V] f32 on the CPU."""
    from llama_box_tpu_torch.models import llama
    T, C = 320, 1024
    rng = np.random.default_rng(6)
    toks = rng.integers(3, cfg.vocab_size, (2, 1, T)).astype(np.int32)
    kv = llama.init_kv_cache(cfg, 1, C, kv_dtype, device=device)
    cos, sin = llama.make_rope(cfg, C, device=device)
    out = []
    for i in range(2):
        lg, kv = llama.prefill_batch_impl(
            params, cfg, torch.from_numpy(toks[i]), np.array([i * T]),
            np.array([T]), kv, cos, sin)
        out.append(lg.float().cpu())
    lg, kv = llama.forward_impl(params, cfg, torch.from_numpy(toks[0, :, :1]),
                                np.array([[2 * T]]), kv, cos, sin)
    out.append(lg[:, 0].float().cpu())
    return torch.cat(out)


def attn_variant_phase(dev, seed, tmp, refs=None) -> dict:
    """Phase 12 (see the module docstring); `refs` as phase 11's (the
    host forwards long_forward's 640 positions)."""
    log("== phase 12: attention variants at published widths: "
        + ", ".join(ATTN_VARIANTS))
    t_phase = time.perf_counter()
    out = {}
    for name in ATTN_VARIANTS:
        r = _reference(refs, tmp, name, seed, "long")
        path, ref = r["path"], r["ref"]
        out[name] = {mode: variant_serve(
            dev, seed, tmp, name, path, mode, ref, paths=ATTN_PATHS,
            prompt_len=ATTN_PROMPT, forward=long_forward,
            extra=(gemma3_span_check(seed, tmp)
                   if name == "gemma3-1b" and mode == "bf16" else None))
            for mode in ATTN_PATHS}
        os.remove(path)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 12: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: a mixture-of-experts model at published widths

MOE_NAME = "qwen3-30b-a3b"
# each phase 13 path: CLI flags, and the kernels one request must launch
# (all others: none). An MoE layer keeps the fused tail's gate shut: on
# w8a8 the attention projections take w8a8_matmul (and the fused q/k/v
# and output kernels at decode rows), the experts stay bf16
MOE_PATHS = {
    "bf16": ([], {MOE_NAME: ("row_norm", "flash_prefill", "flash_decode",
                             "moe_ffn")}),
    "w8a8": (["--weights-dtype", "quantized"],
             {MOE_NAME: ("row_norm", "flash_prefill", "flash_decode",
                         "moe_ffn", "w8a8_matmul", "fused_norm_qmm")}),
}


def moe_checks(seed, mode):
    """Phase 13's checks on the served engine: the verify rows' bits
    against one-row steps (phase 8's verify_bits, bf16 and int8 caches)
    and, on the bf16 path, a self-drafting wave (the served params as the
    draft, graphs) counting its kernels from 0."""
    def run(engine, routes, counters):
        out = {"bits": verify_bits(engine, seed)}
        log(f"  {MOE_NAME} {mode}: verify rows vs one-row steps: "
            f"{out['bits']}")
        for tag, b in out["bits"].items():
            assert b["logits_equal"] and b["kv_equal"], (mode, tag, b)
        if mode == "bf16":
            tok = engine.tokenizer
            rng = np.random.default_rng(seed + 131)
            texts = [make_prompt(tok, rng, SPEC_PROMPT)
                     for _ in range(N_SLOTS)]
            warm = [make_prompt(tok, rng, SPEC_PROMPT)
                    for _ in range(N_SLOTS)]
            w = spec_run(routes, _spec_engine(
                engine, (engine.cfg, engine.params), dataclasses.replace(
                    engine.ecfg, draft_max=SPEC_DRAFT, draft_p_min=0.0)),
                texts, warm, counters)
            w.pop("margins")
            _log_wave("self-draft", w)
            assert w["drafted"] > 0 and w["launches"]["moe_ffn"] > 0
            out["self_draft"] = w
        return out
    return run


def moe_phase(dev, seed, tmp, refs=None) -> dict:
    """Phase 13 (see the module docstring); `refs` as phase 11's."""
    c = MOE_VARIANTS[MOE_NAME]
    log(f"== phase 13: a mixture-of-experts model at published widths: "
        f"{MOE_NAME}, {c['L']} of 48 layers, {c['X']} experts, {c['K']} a "
        f"token")
    t_phase = time.perf_counter()
    r = _reference(refs, tmp, MOE_NAME, seed)
    out = {MOE_NAME: {mode: variant_serve(
        dev, seed, tmp, MOE_NAME, r["path"], mode, r["ref"],
        paths=MOE_PATHS, extra=moe_checks(seed, mode))
        for mode in MOE_PATHS}}
    os.remove(r["path"])
    out["layers"] = r["layers"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: multi-head latent attention at published widths

# each phase 14 path: CLI flags, and the kernels one request must launch
# (all others: none). The low-rank projections stay dense on w8a8 (the
# JAX loader's optional keys); DeepSeek's plain wq, wo, dense FFN and
# output quantize (w8a8_matmul; the output's norm-quantize-matmul at
# decode rows; its layer groups are never fused, so no fused tail); the
# experts stay bf16. MiniCPM3's wo and FFN quantize (w8a8_matmul at
# prefill, the fused tail at decode); its output (73448 rows, no multiple
# of 64) stays dense
MLA_PATHS = {
    "bf16": ([], {"deepseek-v2-lite": ("row_norm", "flash_prefill",
                                       "flash_decode", "moe_ffn"),
                  "minicpm3-4b": ("row_norm", "flash_prefill",
                                  "flash_decode")}),
    "w8a8": (["--weights-dtype", "quantized"],
             {"deepseek-v2-lite": ("row_norm", "flash_prefill",
                                   "flash_decode", "moe_ffn", "w8a8_matmul",
                                   "fused_norm_qmm"),
              "minicpm3-4b": ("row_norm", "flash_prefill", "flash_decode",
                              "w8a8_matmul", "fused_layer_tail")}),
}


def mla_checks(seed, mode, name):
    """Phase 14's checks on the served engine: the verify rows' bits
    against one-row steps (phase 8's verify_bits, bf16 and int8 caches);
    on MiniCPM3 (uniform layers: chains) greedy K = 1 against K = 16 on
    fresh engines (graphs, the served params)."""
    def run(engine, routes, counters):
        from llama_box_tpu_torch.server.engine import Engine
        out = {"bits": verify_bits(engine, seed)}
        log(f"  {name} {mode}: verify rows vs one-row steps: {out['bits']}")
        for tag, b in out["bits"].items():
            assert b["logits_equal"] and b["kv_equal"], (name, mode, tag, b)
        if name == "minicpm3-4b":
            tok = engine.tokenizer
            rng = np.random.default_rng(seed + 141)
            prompts = [tok.encode(make_prompt(tok, rng, VARIANT_PROMPT))
                       for _ in range(N_SLOTS)]
            texts = {k: greedy_run(Engine, dataclasses.replace(
                engine.ecfg, decode_chain=k), engine.cfg, engine.params,
                tok, prompts, 48, engine.device) for k in (1, CHAIN)}
            out["k1_equals_k16"] = texts[1] == texts[CHAIN]
            log(f"  {name} {mode}: greedy K=1 vs K={CHAIN}: "
                f"{'identical' if out['k1_equals_k16'] else 'DIFFERENT'}")
            assert out["k1_equals_k16"], (name, mode)
        return out
    return run


def mla_phase(dev, seed, tmp, refs=None) -> dict:
    """Phase 14 (see the module docstring); `refs` as phase 11's."""
    log("== phase 14: multi-head latent attention at published widths: "
        + ", ".join(MLA_VARIANTS))
    t_phase = time.perf_counter()
    out = {}
    for name in MLA_VARIANTS:
        r = _reference(refs, tmp, name, seed)
        path = r["path"]
        log(f"  {name}: {r['layers']} layers in {r['groups']} group(s), K "
            f"{r['k']} / V {r['v']}, {r['heads']} heads")
        out[name] = {mode: variant_serve(
            dev, seed, tmp, name, path, mode, r["ref"], paths=MLA_PATHS,
            extra=mla_checks(seed, mode, name)) for mode in MLA_PATHS}
        out.setdefault("layers", {})[name] = r["layers"]
        os.remove(path)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 14: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 15: image and audio chats with --mmproj at published widths

# the language models (write_variant's Q8_0 files; depth cut to 4 layers)
MM_VARIANTS = {
    # liuhaotian/llava-v1.5-7b: Llama-2-7B widths (32 x 4096, 32 heads of
    # 128, FF 11008, vocab 32000, untied output)
    "llava-1.5-7b": dict(arch="llama", L=4, E=4096, H=32, HKV=32, D=128,
                         FF=11008, V=32000, rot=128, eps=1e-5,
                         base=10000.0, ctx=4096),
    # Qwen/Qwen2-VL-2B-Instruct: Qwen2-1.5B widths (28 x 1536, 12 / 2
    # heads of 128, FF 8960, vocab 151936, qkv biases, tied embeddings),
    # rope base 1e6, M-RoPE sections [16, 24, 24]
    "qwen2-vl-2b": dict(arch="qwen2vl", L=4, E=1536, H=12, HKV=2, D=128,
                        FF=8960, V=151936, rot=128, eps=1e-6, base=1e6,
                        ctx=32768, sections=(16, 24, 24, 0)),
    # Qwen/Qwen2-Audio-7B-Instruct: Qwen-7B widths (32 x 4096, 32 heads of
    # 128, FF 11008, vocab 156032, qkv biases, untied output)
    "qwen2-audio-7b": dict(arch="qwen2", L=4, E=4096, H=32, HKV=32, D=128,
                           FF=11008, V=156032, rot=128, eps=1e-6,
                           base=10000.0, ctx=8192),
}
# their mmproj towers (F16 matrices, F32 vectors, random from the seed)
MM_TOWERS = {
    # openai/clip-vit-large-patch14-336 as llama.cpp's llava converter
    # keeps it: 23 of 24 blocks (the penultimate layer's output, no post
    # norm), 1024 wide, 16 heads, FF 4096, quick GELU, image 336 / patch
    # 14 (576 tokens and CLS), pre-LN; the mlp projector 1024 -> 4096 ->
    # 4096
    "llava-1.5-7b": dict(kind="clip", proj="mlp", E=1024, H=16, FF=4096,
                         L=23, img=336, patch=14, out=4096),
    # Qwen2-VL's ViT: 32 x 1280, 16 heads, FF 5120, patch 14, temporal
    # patch 2 (two conv slices), quick GELU, LayerNorms with biases; the
    # merger (ln_q, 2x2 merge, 5120 -> 5120 -> 1536); image_size 560 as
    # llama.cpp's converter writes it; depth cut to 8 of 32 blocks (the f32
    # host reference's time)
    "qwen2-vl-2b": dict(kind="qwen2vl", proj="qwen2vl_merger", E=1280, H=16,
                        FF=5120, L=8, img=560, patch=14, out=1536),
    # whisper-large-v3's encoder: 32 x 1280, 20 heads, FF 5120, 128 mel
    # bins, 1500 positions; Qwen2-Audio's head (frames pooled in pairs,
    # then the post norm and one linear 1280 -> 4096); 8 of 32 blocks
    "qwen2-audio-7b": dict(kind="whisper", proj="qwen2a", E=1280, H=20,
                           FF=5120, L=8, mels=128, out=4096),
}
MM_PATHS = {"llava-1.5-7b": ("bf16", "w8a8"), "qwen2-vl-2b": ("bf16",),
            "qwen2-audio-7b": ("bf16",)}
MM_FLAGS = {"bf16": [], "w8a8": ["--weights-dtype", "quantized"]}
MM_TOKENS = 32
MM_EMB_COS, MM_LOGIT_COS = 0.999, 0.99
# Qwen2-VL's served decode steps against the f32 host forward: steps
# held, and the bound on their top log-prob gaps' RMS error over the RMS
# of the host's centred logits (a bf16 forward through 4 layers: about
# 0.02, as a first-token logits cosine of 0.9999 gives)
MM_DECODE_STEPS, MM_DECODE_GAP = 4, 0.06
# CLIP's normalization (llava and Qwen2-VL both take OpenAI CLIP's)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _f16_random(rng, shape, std=0.02) -> bytes:
    return (rng.standard_normal(shape, dtype=np.float32) * std).astype(
        np.float16).tobytes()


def write_mmproj(path: str, name: str, seed: int, t=None) -> None:
    """The synthetic mmproj of MM_TOWERS[name] (or the tower dict `t`):
    tensor names and metadata as llama.cpp's converters write them."""
    from llama_box_tpu_torch.gguf import GGMLType, GGUFWriter
    t = t or MM_TOWERS[name]
    rng = np.random.default_rng(seed + 151)
    w = GGUFWriter(path, architecture="clip")
    E_, FF_, L_ = t["E"], t["FF"], t["L"]
    audio = t["kind"] == "whisper"
    sec = "audio" if audio else "vision"
    w.add_kv("clip.has_vision_encoder", not audio)
    w.add_kv("clip.has_audio_encoder", audio)
    w.add_kv("clip.projector_type", t["proj"])
    for k, v in (("embedding_length", E_), ("feed_forward_length", FF_),
                 ("block_count", L_), ("attention.head_count", t["H"]),
                 ("attention.layer_norm_epsilon", 1e-5 if audio else 1e-6),
                 ("projection_dim", t["out"])):
        w.add_kv(f"clip.{sec}.{k}", v)
    if audio:
        w.add_kv("clip.audio.num_mel_bins", t["mels"])
    else:
        w.add_kv("clip.vision.image_size", t["img"])
        w.add_kv("clip.vision.patch_size", t["patch"])
        w.add_kv("clip.vision.image_mean", np.asarray(CLIP_MEAN, np.float32))
        w.add_kv("clip.vision.image_std", np.asarray(CLIP_STD, np.float32))
    f16 = GGMLType.F16

    def mat(tname, *shape, std=0.02):
        w.add_raw_tensor(tname, shape, f16, _f16_random(rng, shape, std))

    def vec(tname, n, one=False):
        x = rng.standard_normal(n, dtype=np.float32) * 0.02
        w.add_tensor(tname, x + 1.0 if one else x)

    pre = "a" if audio else "v"
    if audio:
        mat("a.conv1d.1.weight", E_, t["mels"], 3)
        vec("a.conv1d.1.bias", E_)
        mat("a.conv1d.2.weight", E_, E_, 3)
        vec("a.conv1d.2.bias", E_)
        mat("a.position_embd.weight", 1500, E_)
    else:
        P = t["patch"]
        mat("v.patch_embd.weight", E_, 3, P, P)
        if t["kind"] == "qwen2vl":
            mat("v.patch_embd.weight.1", E_, 3, P, P)
        elif t["kind"] == "clip":
            vec("v.class_embd", E_)
            mat("v.position_embd.weight", (t["img"] // P) ** 2 + 1, E_)
            vec("v.pre_ln.weight", E_, one=True)
            vec("v.pre_ln.bias", E_)
        else:                       # siglip-like: learned positions only
            mat("v.position_embd.weight", (t["img"] // P) ** 2, E_)
    for i in range(L_):
        p = f"{pre}.blk.{i}."
        for nm in ("ln1", "ln2"):
            vec(p + nm + ".weight", E_, one=True)
            vec(p + nm + ".bias", E_)
        for nm in ("attn_q", "attn_k", "attn_v", "attn_out"):
            mat(p + nm + ".weight", E_, E_)
            if not (audio and nm == "attn_k"):      # whisper: no k bias
                vec(p + nm + ".bias", E_)
        mat(p + "ffn_up.weight", FF_, E_)
        vec(p + "ffn_up.bias", FF_)
        mat(p + "ffn_down.weight", E_, FF_)
        vec(p + "ffn_down.bias", E_)
    if audio:
        vec("a.post_ln.weight", E_, one=True)
        vec("a.post_ln.bias", E_)
        mat("mm.a.fc1.weight", t["out"], E_)
        vec("mm.a.fc1.bias", t["out"])
    elif t["kind"] == "qwen2vl":
        vec("v.post_ln.weight", E_, one=True)       # the merger's ln_q
        vec("v.post_ln.bias", E_)
        mat("mm.0.weight", 4 * E_, 4 * E_)
        vec("mm.0.bias", 4 * E_)
        mat("mm.2.weight", t["out"], 4 * E_)
        vec("mm.2.bias", t["out"])
    else:
        mat("mm.0.weight", t["out"], E_)
        vec("mm.0.bias", t["out"])
        mat("mm.2.weight", t["out"], t["out"])
        vec("mm.2.bias", t["out"])
    w.write()


def write_mm_pair(tmp: str, name: str, seed: int) -> tuple[str, str]:
    """Phase 15's two files of `name` (a worker writes them beside the
    kernel phases): the language model and its mmproj."""
    lm = f"{tmp}/synthetic-{name}-q8_0.gguf"
    mm = f"{tmp}/synthetic-{name}-mmproj-f16.gguf"
    write_variant(lm, name, seed)
    write_mmproj(mm, name, seed)
    return lm, mm


def png_bytes(w: int, h: int, seed: int) -> bytes:
    """An 8-bit RGB PNG written with zlib: smooth random colour fields
    and noise from `seed` (filter 0 on every row)."""
    import zlib
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        fx, fy, ph = rng.uniform(0.005, 0.05, 2).tolist() + [
            rng.uniform(0, 6.3)]
        img[..., c] = 127 + 100 * np.sin(fx * xx + fy * yy + ph)
    img += rng.normal(0, 12, img.shape)
    px = np.clip(img, 0, 255).astype(np.uint8)
    raw = b"".join(b"\x00" + px[r].tobytes() for r in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return (len(data).to_bytes(4, "big") + body
                + (zlib.crc32(body) & 0xFFFFFFFF).to_bytes(4, "big"))
    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([8, 2, 0, 0, 0]))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def wav_bytes(seconds: float, seed: int) -> bytes:
    """A 16 kHz mono 16-bit WAV of tones and noise from `seed`."""
    import io
    import wave
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = sum(rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * rng.uniform(100, 3000)
                                           * t) for _ in range(4))
    x = x + 0.02 * rng.standard_normal(len(t))
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _media_part(kind: str, data: bytes) -> dict:
    import base64
    b64 = base64.b64encode(data).decode()
    if kind == "audio":
        return {"type": "input_audio",
                "input_audio": {"data": b64, "format": "wav"}}
    return {"type": "image_url",
            "image_url": {"url": "data:image/png;base64," + b64}}


def _mm_messages(text: str, media: list) -> list:
    """A chat's one user message: the text, then the media parts."""
    parts = [{"type": "text", "text": text}] \
        + [_media_part(k, d) for k, d in media]
    return [{"role": "user", "content": parts if media else text}]


def mm_chat(url, text: str, media: list, n=MM_TOKENS, **extra):
    """A greedy ignore_eos chat with media parts (and `extra` request
    fields): (content, usage)."""
    import urllib.error
    try:
        st, body, _ = http(url + "/v1/chat/completions", dict(
            messages=_mm_messages(text, media), max_tokens=n, temperature=0,
            ignore_eos=True, **extra))
    except urllib.error.HTTPError as e:
        raise AssertionError(f"{e.code}: {e.read()[:300]!r}") from None
    assert st == 200, st
    b = json.loads(body)
    assert b["usage"]["completion_tokens"] == n, b["usage"]
    return b["choices"][0]["message"]["content"], b["usage"]


def _mm_media(name: str, seed: int) -> list:
    """Each model's media: (kind, bytes) items."""
    if name == "qwen2-audio-7b":
        return [("audio", wav_bytes(3.0, seed + 1)),
                ("audio", wav_bytes(3.0, seed + 2))]
    if name == "qwen2-vl-2b":       # two aspects: 32 x 24 and 20 x 36 patches
        return [("image", png_bytes(448, 336, seed + 3)),
                ("image", png_bytes(280, 504, seed + 4))]
    return [("image", png_bytes(640, 480, seed + 5)),
            ("image", png_bytes(300, 420, seed + 6))]


def _mm_prompt(routes, text: str, media: list):
    """A chat's prompt as the server builds it, by the server's own code
    (its message join, the chat template, _media_chunks): (flat ids,
    chunks, mrope_delta)."""
    from llama_box_tpu_torch.server.http import _normalize_messages
    msgs, items = _normalize_messages(_mm_messages(text, media), routes.mp)
    return routes._media_chunks(
        routes.chat.apply(msgs, add_generation_prompt=True), items)


def _prefill_chunks(params, cfg, chunks, device, kv_dtype, ubatch, span):
    """A prompt's chunks prefilled in turn (ubatches of `ubatch` rows)
    into a 1-slot cache, as the engine's _prefill_chunk does: M-RoPE
    streams where the config has sections, the image span where `span`.
    Returns (the last row's logits [1, V], kv, cos, sin, positions)."""
    from llama_box_tpu_torch.models import llama
    C = 1024
    kv = llama.init_kv_cache(cfg, 1, C, kv_dtype, device=device)
    cos, sin = llama.make_rope(cfg, C, device=device)
    dt = params["tok_embd"].dtype
    pos = 0
    lg = None
    for ch in chunks:
        start = pos
        for off in range(0, len(ch[1]), ubatch):
            n = min(ubatch, len(ch[1]) - off)
            kw = {}
            if cfg.mrope_sections:
                kw["mrope_pos"] = torch.from_numpy(np.ascontiguousarray(
                    ch[-1][:, off:off + n]))[:, None].to(device)
            if ch[0] == "tokens":
                toks = torch.tensor([ch[1][off:off + n]], device=device)
            else:
                toks = None
                kw["embeds"] = torch.from_numpy(np.array(
                    ch[1][off:off + n], np.float32))[None].to(device, dt)
                if span:
                    kw["bidir"] = torch.tensor([[start, pos + n]],
                                               device=device)
            lg, kv = llama.prefill_batch_impl(params, cfg, toks, [pos], [n],
                                              kv, cos, sin, **kw)
            pos += n
    return lg, kv, cos, sin, pos


def chunk_logits(params, cfg, chunks, device, kv_dtype, ubatch=N_UBATCH,
                 span=False):
    """The last-row logits [V] f32 (on the CPU) of a prompt's chunks
    prefilled in turn (_prefill_chunks)."""
    lg = _prefill_chunks(params, cfg, chunks, device, kv_dtype, ubatch,
                         span)[0]
    return lg[0].float().cpu()


def host_forward(params, cfg, chunks, tokens=(), delta=0) -> list:
    """The f32 host forward (CPU) of a prompt's chunks, then of `tokens`
    fed one at a time, each at its cache position and rotated at position
    + delta (the engine's decode; under M-RoPE a text row's three streams
    are equal): the logits [V] after the prompt and after each token."""
    from llama_box_tpu_torch.models import llama
    lg, kv, cos, sin, pos = _prefill_chunks(params, cfg, chunks, "cpu",
                                            torch.float32, N_UBATCH, False)
    out = [lg[0]]
    for t in tokens:
        kw = {}
        if cfg.mrope_sections:
            kw["mrope_pos"] = torch.full((3, 1, 1), pos + delta)
        lg, kv = llama.prefill_batch_impl(params, cfg, torch.tensor([[t]]),
                                          [pos], [1], kv, cos, sin, **kw)
        out.append(lg[0])
        pos += 1
    return out


def served_request(engine, fn):
    """fn() (one request, alone on the served engine) under two spies on
    the engine: the request's task as the route submits it, and its first
    answer token's logits [V] f32 as the engine's prefill program
    computed them, read from that program's output where the engine reads
    it (before any later replay of its graph). Returns (fn's result, the
    task, the logits)."""
    tasks, rows = [], []
    submit, finish = engine.submit, engine._finish_batch_sync

    def spy_submit(task):
        tasks.append(task)
        return submit(task)

    def spy_finish(done, pend, ramp_set, logits):
        rows.extend(logits[s.idx].float().cpu() for s in done)
        return finish(done, pend, ramp_set, logits)

    engine.submit, engine._finish_batch_sync = spy_submit, spy_finish
    try:
        out = fn()
    finally:
        del engine.submit, engine._finish_batch_sync
    assert len(tasks) == 1 and len(rows) == 1, (len(tasks), len(rows))
    return out, tasks[0], rows[0]


def decode_gap_err(task, host, steps: int) -> list:
    """Decode steps 1..steps of a served greedy task held against the f32
    host forward (host[j]: the logits before token j): the served top-N
    log-prob gaps to the top token (log p_i - log p_0 = l_i - l_0 under
    greedy: one softmax over the candidates) against the host's logit
    gaps at the same ids; each step's RMS error over the RMS of the host's
    centred logits."""
    out = []
    for j in range(1, steps + 1):
        tp = task.probs[j]
        ids = torch.tensor(tp.top_ids)
        lp = torch.tensor(tp.top_probs, dtype=torch.float64).log()
        h = host[j].double()
        err = (lp - lp[0]) - (h[ids] - h[ids[0]])
        out.append(float(err.square().mean().sqrt()
                         / (h - h.mean()).square().mean().sqrt()))
    return out


def tower_checks(mp, host_mp, media, dev) -> dict:
    """Each media item's projected rows on the card against the f32 host
    tower (the same plain torch ops on the CPU; the lowest cosine of a
    row), and the card's device ms of one run (CUDA events, warm)."""
    from llama_box_tpu_torch.models.audio import (decode_wav, encode_audio,
                                                  encode_audio_impl,
                                                  log_mel_spectrogram)
    out = {"emb_cos": [], "tower_ms": [], "rows": []}
    for kind, data in media:
        if kind == "audio":
            host = encode_audio(host_mp.audio_cfg, host_mp.audio_params, data)
            card = encode_audio(mp.audio_cfg, mp.audio_params, data)
            mel = torch.from_numpy(log_mel_spectrogram(
                decode_wav(data), mp.audio_cfg["n_mels"])).to(dev)

            def run(mel=mel):
                with torch.no_grad():
                    return encode_audio_impl(mp.audio_cfg, mp.audio_params,
                                             mel)
        else:
            pixels, grid = mp.pixels(data)
            host = host_mp.tower(pixels, grid).numpy()
            card = mp.tower(pixels, grid).float().cpu().numpy()

            def run(pixels=pixels, grid=grid):
                return mp.tower(pixels, grid)
        run()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(3):
            run()
        e1.record()
        torch.cuda.synchronize()
        out["tower_ms"].append(e0.elapsed_time(e1) / 3)
        out["emb_cos"].append(_cosine(torch.from_numpy(card),
                                      torch.from_numpy(host)))
        out["rows"].append(int(card.shape[0]))
    return out


def mm_greedy(eng, tok, prompts, chunks, n) -> list:
    """Greedy ignore_eos tokens of chunked prompts on a started engine."""
    from llama_box_tpu_torch.sampling import SamplerParams
    from llama_box_tpu_torch.server.task import CompletionsTask
    tasks = [CompletionsTask(p, SamplerParams(temp=0.0, ignore_eos=True),
                             tokenizer=tok, max_tokens=n, chunks=c)
             for p, c in zip(prompts, chunks)]
    for t in tasks:
        eng.submit(t)
    return [list(wait_final(t).generated) for t in tasks]


def mm_serve(dev, seed, name, lm, mm, mode, host) -> dict:
    """One phase 15 model on one path, served by the CLI with --mmproj:
    on bf16 the tower checks; two warm-up waves of the measured wave's
    media (so its every program key has run and been captured), then the
    measured wave of 4 greedy chats at -np 4 -c 8192 (a text-only chat
    beside media chats, one with both media items), its captures and the
    graphs' pool printed; the first media chat again (from the prefix
    cache: the same text); one media request counting its kernels from
    0, whose served first answer token's logits are held against the f32
    host forward of the same chunks (on Qwen2-VL also its decode steps'
    top log-prob gaps, at position + mrope_delta); on llava greedy K = 1
    against K = 16 on fresh engines."""
    from llama_box_tpu_torch import cli
    from llama_box_tpu_torch.server.engine import Engine
    from llama_box_tpu_torch.server.metrics import Metrics
    t0 = time.perf_counter()
    engine, srv = cli.build_server([
        "-m", lm, "--mmproj", mm, "--port", "0", "-np", str(N_SLOTS),
        "-c", str(N_CTX), "-ub", str(N_UBATCH), "--decode-chain", str(CHAIN),
        "--no-jinja", "--device", dev.type] + MM_FLAGS[mode])
    load_s = time.perf_counter() - t0
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    routes = srv.RequestHandlerClass.routes
    mp, counters = routes.mp, kernel_counters()
    media = _mm_media(name, seed)
    res = dict(load_s=load_s)
    try:
        if mode == "bf16":
            res.update(tower_checks(mp, host["mp"], media, dev))
            log(f"  {name}: tower rows {res['rows']}, device ms "
                + ", ".join(f"{x:.3f}" for x in res["tower_ms"])
                + "; cosine to the f32 host tower "
                + ", ".join(f"{x:.6f}" for x in res["emb_cos"]))
            assert min(res["emb_cos"]) >= MM_EMB_COS, (name, res["emb_cos"])
        tok = engine.tokenizer
        rng = np.random.default_rng(seed + 161)
        words = [make_prompt(tok, rng, 24) for _ in range(12)]

        def wave_of(ask, w):
            return [(w[0], []), (ask, media[:1]), (w[1], media[1:]),
                    (ask + w[2], media)]
        ask = "describe this "
        wave = wave_of(ask, words)
        # two waves of the same media and like texts (nothing from the
        # prefix cache): the measured wave's program keys run eagerly,
        # then are captured
        for a, w in (("explain this ", words[6:9]), ("show me this ",
                                                     words[9:12])):
            concurrently([lambda t=t, m=m: mm_chat(url, t, m)
                          for t, m in wave_of(a, w)])
        engine.metrics = Metrics()
        n_graphs = engine.graphs.n_graphs
        t_w = time.perf_counter()
        got = concurrently([lambda t=t, m=m: mm_chat(url, t, m)
                            for t, m in wave])
        wall = time.perf_counter() - t_w
        m = engine.metrics.snapshot()
        res["captured_in_wave"] = engine.graphs.n_graphs - n_graphs
        res["graphs"] = engine.graphs.n_graphs
        res["mm_graphs"] = sum(k[0] == "prefill_mm"
                               for k in engine.graphs._graphs)
        res["pool_mib"] = engine.graphs.pool_bytes / 2 ** 20
        again, usage = mm_chat(url, ask, media[:1])
        res["cached_again"] = usage["prompt_tokens_details"]["cached_tokens"]
        res["same_from_cache"] = again == got[1][0]
        for fn in counters.values():
            fn.launches = 0
        # one media request, its first token's logits (and on Qwen2-VL its
        # top log-probs) read from the served request
        steps = MM_DECODE_STEPS if engine.cfg.mrope_sections else 0
        extra = dict(logprobs=True, top_logprobs=16) if steps else {}
        (_, one_usage), task, card = served_request(
            engine, lambda: mm_chat(url, words[5], media[:1], **extra))
        res["launches_one_request"] = {k: fn.launches
                                       for k, fn in counters.items()}
        res.update(
            prompt_tokens=[u["prompt_tokens"] for _, u in got],
            prefill_tok_s=m["n_prefill_total"] / m["t_prefill_total_ms"] * 1e3,
            decode_tok_s=m["n_decode_total"] / m["t_decode_total_ms"] * 1e3,
            window_tok_s=len(wave) * MM_TOKENS / wall,
            texts=[c for c, _ in got])
        # the f32 host forward of the chunks the server built for it
        flat, chunks, delta = _mm_prompt(routes, words[5], media[:1])
        assert len(flat) == one_usage["prompt_tokens"] \
            and list(task.prompt_tokens) == list(flat), len(flat)
        ref = host_forward(host["params"], host["cfg"], chunks,
                           task.generated[:steps], delta)
        res["logits_cos"] = _cosine(card[None], ref[0][None])
        if steps:
            assert len(task.probs) == len(task.generated), len(task.probs)
            res["mrope_delta"] = delta
            res["decode_gap_err"] = decode_gap_err(task, ref, steps)
            # the same steps held against the host rotated without delta
            res["decode_gap_err_no_delta"] = decode_gap_err(
                task, host_forward(host["params"], host["cfg"], chunks,
                                   task.generated[:steps]), steps)
        if name == "llava-1.5-7b":
            built = [_mm_prompt(routes, t, md) for t, md in wave[1:]]
            runs = {}
            for k in (1, CHAIN):
                eng = Engine(engine.cfg, engine.params, tok,
                             dataclasses.replace(engine.ecfg,
                                                 decode_chain=k),
                             device=str(engine.device))
                eng.start()
                try:
                    runs[k] = mm_greedy(eng, tok, [b[0] for b in built],
                                        [b[1] for b in built], MM_TOKENS)
                finally:
                    eng.stop()
            res["k1_equals_k16"] = runs[1] == runs[CHAIN]
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
        thread.join(timeout=30)
    lc = res["launches_one_request"]
    log(f"  {name} {mode}: loaded in {load_s:.1f} s; prompt tokens "
        f"{res['prompt_tokens']}; prefill tok/s {res['prefill_tok_s']:.1f}, "
        f"decode tok/s {res['decode_tok_s']:.1f}, window tok/s "
        f"{res['window_tok_s']:.1f} ({res['captured_in_wave']} captures in "
        f"the measured wave; {res['graphs']} graphs, {res['mm_graphs']} of "
        f"them multimodal prefill, pool {res['pool_mib']:.1f} MiB); the "
        f"served first-token logits' cosine to the f32 host forward "
        f"{res['logits_cos']:.6f}"
        + (f"; decode steps' top-16 log-prob gaps vs the host at position "
           f"+ delta ({res['mrope_delta']}): RMS err / RMS logit "
           + ", ".join(f"{x:.4f}" for x in res["decode_gap_err"])
           + " (without delta: "
           + ", ".join(f"{x:.4f}" for x in res["decode_gap_err_no_delta"])
           + ")" if "decode_gap_err" in res else "")
        + f"; again from the prefix cache "
        f"({res['cached_again']} cached): same text {res['same_from_cache']}"
        + (f"; greedy K=1 vs K={CHAIN}: {res['k1_equals_k16']}"
           if "k1_equals_k16" in res else "")
        + f"; one media request: flash_prefill {lc['flash_prefill']}, "
        f"flash_decode {lc['flash_decode']} launches ({lc})")
    for i, text in enumerate(res["texts"]):
        log(f"    chat {i}: {(text or '')[:60]!r}")
    assert res["logits_cos"] >= MM_LOGIT_COS, (name, mode, res["logits_cos"])
    assert max(res.get("decode_gap_err", [0.0])) <= MM_DECODE_GAP, res
    assert res["same_from_cache"], (name, mode)
    assert res["cached_again"] >= res["prompt_tokens"][1] - 1, res
    assert res.get("k1_equals_k16", True), (name, mode)
    assert lc["flash_prefill"] > 0 and lc["flash_decode"] > 0, lc
    if mode == "w8a8":
        assert lc["w8a8_matmul"] > 0, lc
    return res


def mm_phase(dev, seed, pairs) -> dict:
    """Phase 15 (see the module docstring); `pairs` are the files workers
    wrote beside the kernel phases."""
    from llama_box_tpu_torch.cli import load_multimodal
    from llama_box_tpu_torch.models.loader import load_model
    log("== phase 15: image and audio chats with --mmproj: "
        + ", ".join(MM_VARIANTS))
    t_phase = time.perf_counter()
    out = {}
    for name, (lm, mm) in pairs.items():
        t0 = time.perf_counter()
        cfg, params = load_model(lm, dtype=torch.float32, device="cpu")
        host = dict(cfg=cfg, params=params,
                    mp=load_multimodal(mm, cfg.n_embd, "cpu"))
        log(f"  {name}: the f32 host model and towers loaded in "
            f"{time.perf_counter() - t0:.1f} s")
        out[name] = {mode: mm_serve(dev, seed, name, lm, mm, mode, host)
                     for mode in MM_PATHS[name]}
        del host, params
        os.remove(lm)
        os.remove(mm)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 15: {out['seconds']:.1f} s")
    return out


# phase 12's gemma3 image file: an mlp mmproj at SigLIP-So400m's widths
# (1152 wide, 16 heads, FF 4304, patch 14, image 224: 256 tokens; 2 of its
# 27 blocks), projecting 1152 -> 1152 -> 1152 into Gemma-3-1B
GEMMA_TOWER = dict(kind="siglip", proj="mlp", E=1152, H=16, FF=4304, L=2,
                   img=224, patch=14, out=1152)


def gemma3_span_check(seed, tmp):
    """Phase 12's extra on Gemma-3-1B's bf16 path: an image chat through
    the engine (its image rows prefilled under the bidirectional span,
    the flash prefill kernel counted), and the logits of that prompt,
    spanned, through the kernel against its plain version on the same
    card and inputs (and against the same without the span)."""
    def run(engine, routes, counters):
        from llama_box_tpu_torch.cli import load_multimodal
        from llama_box_tpu_torch.models import llama
        from llama_box_tpu_torch.ops import flash_prefill as fp
        path = f"{tmp}/synthetic-gemma3-mmproj-f16.gguf"
        write_mmproj(path, "gemma3", seed, GEMMA_TOWER)
        routes.mp = load_multimodal(path, engine.cfg.n_embd, engine.device)
        os.remove(path)
        media = [("image", png_bytes(320, 240, seed + 7))]
        flat, chunks, _ = _mm_prompt(routes, "what is this ", media)
        for fn in counters.values():
            fn.launches = 0
        gen = mm_greedy(engine, engine.tokenizer, [flat], [chunks], 8)[0]
        launches = counters["flash_prefill"].launches
        # the image's 256 rows in ubatches of 128: the span crosses one
        kw = dict(device=engine.device, kv_dtype=torch.bfloat16, ubatch=128)
        kern = chunk_logits(engine.params, engine.cfg, chunks, span=True,
                            **kw)
        causal = chunk_logits(engine.params, engine.cfg, chunks, **kw)
        saved = llama.flash_prefill_batched
        try:
            llama.flash_prefill_batched = fp.flash_prefill_plain
            plain = chunk_logits(engine.params, engine.cfg, chunks,
                                 span=True, **kw)
        finally:
            llama.flash_prefill_batched = saved
        err = float((kern - plain).abs().max() / plain.abs().max())
        res = dict(span_prompt_tokens=len(flat),
                   span_prefill_launches=launches,
                   span_cos=_cosine(kern[None], plain[None]),
                   span_rel_err=err,
                   span_vs_causal_cos=_cosine(kern[None], causal[None]))
        log(f"  gemma3-1b with an image: {len(flat)} prompt tokens, "
            f"flash_prefill launches {launches}; the spanned logits, "
            f"kernel vs plain version: cosine {res['span_cos']:.6f}, max "
            f"err {err:.3e} x max|plain|; against the image rows causal: "
            f"cosine {res['span_vs_causal_cos']:.6f}")
        assert launches > 0 and len(gen) == 8
        assert res["span_cos"] >= MM_LOGIT_COS and err <= SPAN_REL, res
        assert not torch.equal(kern, causal), "the span changed nothing"
        return res
    return run


# the spanned logits, kernel against plain version, x max|plain|: bf16
# attention in another order through 6 layers
SPAN_REL = 0.05


# ---------------------------------------------------------------------------
# phase 16: LoRA adapters (per request and merged) and a control vector on
# phase 5's TinyLlama-width model

# the adapters: name -> (rank, alpha, targets, with output.weight's pair);
# a on all seven projections of every layer and the output projection, b
# on q, v and down. Random from the seed at LORA_STD: a delta's std is
# sqrt(rank) x LORA_STD^2 x alpha / rank, about a third of the weights'
# 0.02, so each adapter moves the logits well past bf16 noise
LORA_SHAPES = {"attn_q": (H * D, E), "attn_k": (HKV * D, E),
               "attn_v": (HKV * D, E), "attn_output": (E, H * D),
               "ffn_gate": (FF, E), "ffn_up": (FF, E), "ffn_down": (E, FF)}
LORA_ADAPTERS = {"a": (16, 32.0, tuple(LORA_SHAPES), True),
                 "b": (8, 16.0, ("attn_q", "attn_v", "ffn_down"), False)}
LORA_STD = 0.03
# one wave's adapter mixes, one a slot: the default scales (no field),
# both off, b alone, half of each
LORA_MIXES = (None, [{"id": 0, "scale": 0.0}, {"id": 1, "scale": 0.0}],
              [{"id": 1, "scale": 1.0}],
              [{"id": 0, "scale": 0.5}, {"id": 1, "scale": 0.5}])
# adapter a at its default scale, b off: the static merge's counterpart
LORA_A_ONLY = [{"id": 0, "scale": 1.0}, {"id": 1, "scale": 0.0}]
LORA_PROMPT, LORA_TOKENS = 200, 64
LORA_COS = 0.999
# the control vector: every layer's direction (std CVEC_STD) at scale 0.8,
# layers 2 to 6 (1-based) steered
CVEC_STD, CVEC_SCALE, CVEC_RANGE = 0.2, "0.8", ("2", "3")
# served logits against the f32 host forward with the vector; on w8a8 also
# against the plain versions on the host over the same QTensors, within
# phase 5's w8a8 bound (an int8 code the fused norm's other summation
# order moves shifts a row by more than a bf16 rounding)
CVEC_COS = {"bf16": 0.999, "w8a8": 0.995}
CVEC_PLAIN_COS = 0.99
# the kernels one request under per-request LoRA must launch on each path
# (all others: none): the fused gates are shut by the scale rows, so the
# w8a8 tail never runs; the output projection's norm-quantize-matmul does
LORA_KERNELS = {
    "bf16": ("flash_prefill", "flash_decode", "row_norm"),
    "w8a8": ("flash_prefill", "flash_decode", "w8a8_matmul",
             "fused_norm_qmm", "row_norm"),
    "q4": ("flash_prefill", "flash_decode", "q4_matmul", "q8_matmul",
           "row_norm")}


def write_lora(path: str, name: str, seed: int) -> None:
    """Adapter LORA_ADAPTERS[name] as a GGUF: lora_a [r, in] and lora_b
    [out, r] f32 for each target of every layer (and output.weight's)."""
    from llama_box_tpu_torch.gguf import GGUFWriter
    rank, alpha, targets, with_output = LORA_ADAPTERS[name]
    rng = np.random.default_rng(seed + 160 + len(name) + ord(name[0]))
    w = GGUFWriter(path, architecture="llama")
    for k, v in (("general.type", "adapter"), ("adapter.type", "lora"),
                 ("general.name", f"synthetic-lora-{name}"),
                 ("adapter.lora.alpha", alpha)):
        w.add_kv(k, v)
    pairs = [(f"blk.{i}.{t}", LORA_SHAPES[t]) for i in range(L)
             for t in targets] + ([("output", (V, E))] if with_output else [])
    for base, (n_out, n_in) in pairs:
        for part, shape in (("a", (rank, n_in)), ("b", (n_out, rank))):
            w.add_tensor(f"{base}.weight.lora_{part}", rng.standard_normal(
                shape, dtype=np.float32) * LORA_STD)
    w.write()


def write_cvec(path: str, seed: int) -> None:
    """A control vector GGUF: direction.<N> [E] for every layer N
    (1-based)."""
    from llama_box_tpu_torch.gguf import GGUFWriter
    rng = np.random.default_rng(seed + 169)
    w = GGUFWriter(path, architecture="controlvector")
    for li in range(L):
        w.add_tensor(f"direction.{li + 1}", rng.standard_normal(
            E, dtype=np.float32) * CVEC_STD)
    w.write()


def _lora_chats(url, texts, mixes, n=LORA_TOKENS):
    """Greedy ignore_eos chats of texts[i] under mixes[i] (None: no
    `lora` field), at once: (contents, bodies, wall seconds)."""
    def chat(text, mix):
        body = dict(messages=[{"role": "user", "content": text}],
                    max_tokens=n, temperature=0, ignore_eos=True)
        if mix is not None:
            body["lora"] = mix
        return http(url + "/v1/chat/completions", body)
    t0 = time.perf_counter()
    res = concurrently([lambda t=t, m=m: chat(t, m)
                        for t, m in zip(texts, mixes)])
    wall = time.perf_counter() - t0
    bodies = []
    for st, text, _ in res:
        assert st == 200, st
        b = json.loads(text)
        assert b["usage"]["completion_tokens"] == n, b["usage"]
        bodies.append(b)
    return [b["choices"][0]["message"]["content"] for b in bodies], bodies, \
        wall


def _rates(eng, fn):
    """fn() (a wave on `eng`) under fresh metrics: its result, decode and
    prefill tok/s (the engine's) and the chats' TTFT p50 (fn's bodies)."""
    from llama_box_tpu_torch.server.metrics import Metrics
    eng.metrics = Metrics()
    out = fn()
    m = eng.metrics.snapshot()
    return out, dict(
        decode_tok_s=m["n_decode_total"] / m["t_decode_total_ms"] * 1e3,
        prefill_tok_s=m["n_prefill_total"] / m["t_prefill_total_ms"] * 1e3,
        ttft_p50_ms=statistics.median(
            b["usage"]["time_to_first_token_ms"] for b in out[1]))


def _without_lora(params) -> dict:
    """The param tree without the LoRA stacks and scale rows (the base
    model in the same layout)."""
    return {k: ({n: w for n, w in v.items() if not n.startswith("lora_")}
                if k == "layers" else v)
            for k, v in params.items() if k != "lora_scales"}


def _host_logits(params, cfg, ids, kv_dtype=torch.float32) -> torch.Tensor:
    """The host (CPU, plain versions) forward of one prompt, f32 unless
    the params and `kv_dtype` say otherwise: its last row's logits [V]."""
    from llama_box_tpu_torch.models import llama
    C = -(-len(ids) // 64) * 64
    kv = llama.init_kv_cache(cfg, 1, C, kv_dtype, device="cpu")
    cos, sin = llama.make_rope(cfg, C, device="cpu")
    lg, _ = llama.prefill_batch_impl(params, cfg, torch.tensor([ids]), [0],
                                     [len(ids)], kv, cos, sin)
    return lg[0]


def _cos1(a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.double()[None], b.double()[None])[0])


def _lora_server(dev, mode, extra):
    """The CLI's server of phase 5's `mode` file with `extra` flags, bound
    and serving: (engine, server, url, thread, load seconds)."""
    from llama_box_tpu_torch import cli
    _, _, flags, env, _ = PATHS[mode]
    t0 = time.perf_counter()
    os.environ.update(env)            # the residency switches: load time
    try:
        engine, srv = cli.build_server([
            "-m", _LORA_FILES["model"][mode], "--port", "0", "-np",
            str(N_SLOTS), "-c", str(N_CTX), "-ub", str(N_UBATCH),
            "--decode-chain", str(CHAIN), "--no-jinja", "--device",
            dev.type] + flags + extra)
    finally:
        for k in env:
            del os.environ[k]
    load_s = time.perf_counter() - t0
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return engine, srv, f"http://127.0.0.1:{srv.server_address[1]}", \
        thread, load_s


def _close(engine, srv, thread) -> None:
    srv.shutdown()
    srv.server_close()
    engine.stop()
    thread.join(timeout=30)


_LORA_FILES: dict = {}


def lora_serve(dev, seed, tmp, mode) -> dict:
    """Phase 16a on one path: --lora a --lora b --lora-per-request. Two
    warm-up waves of the four mixes (other prompts), then the measured
    wave (4 greedy chats, LORA_MIXES one a slot: texts, captures, rates),
    the same wave without `lora` fields (its captures), each request
    served alone (texts equal the wave's), the wave at K = 1 (equal to K =
    16), the wave with n-gram drafts (lookup 1, chain 1 as phase 8's;
    equal to plain decode, the drafts counted), one request
    counting its kernels from 0; then the same weights without the stacks
    on a fresh engine behind the same routes (the base: its captures and
    rates after the same waves) and one captured decode step of each
    (kernels a layer). The prefix cache is off (--no-prompt-cache): a
    slot's cached rows keep the adapter mix of the request that left them
    and a request with another mix reuses them, as in JAX (ROADMAP: the
    reference's quirks), so every request here prefills cold, its rows'
    bits those of a cold pass of the same bucket. On bf16 also adapter a
    alone at its default scale (b off), its served first answer token's
    logits returned for the merge check."""
    from llama_box_tpu_torch.server.engine import Engine
    phase = PATHS[mode][0].replace("5", "16")
    log(f"== phase {phase}: per-request LoRA, {mode} path")
    engine, srv, url, thread, load_s = _lora_server(dev, mode, [
        "--lora", _LORA_FILES["a"], "--lora", _LORA_FILES["b"],
        "--lora-per-request", "--no-prompt-cache"])
    routes = srv.RequestHandlerClass.routes
    counters = kernel_counters()
    out: dict = dict(load_s=load_s)
    try:
        tok = engine.tokenizer
        assert engine.n_lora == 2 and engine.cfg.rope_mode == "norm"
        rng = np.random.default_rng(seed + 163)
        warm, texts = ([make_prompt(tok, rng, LORA_PROMPT)
                        for _ in range(N_SLOTS)] for _ in range(2))
        none = [None] * N_SLOTS
        for _ in range(2):
            _lora_chats(url, warm, LORA_MIXES)
        n0 = engine.graphs.n_graphs
        (mixed, bodies, _), rates = _rates(
            engine, lambda: _lora_chats(url, texts, LORA_MIXES))
        graphs_after = engine.graphs.n_graphs
        out.update(lora=rates, captured_mixed=graphs_after - n0)
        n0 = engine.graphs.n_graphs
        _lora_chats(url, texts, none)
        out["captured_no_fields"] = engine.graphs.n_graphs - n0
        alone = [_lora_chats(url, [t], [m])[0][0]
                 for t, m in zip(texts, LORA_MIXES)]
        engine.ecfg = dataclasses.replace(engine.ecfg, decode_chain=1)
        k1 = _lora_chats(url, texts, LORA_MIXES)[0]
        engine.ecfg = dataclasses.replace(engine.ecfg, decode_chain=1,
                                          lookup_ngram_min=1)
        d0 = engine.metrics.n_drafted_total
        ngram = _lora_chats(url, texts, LORA_MIXES)[0]
        drafted = engine.metrics.n_drafted_total - d0
        engine.ecfg = dataclasses.replace(engine.ecfg, decode_chain=CHAIN,
                                          lookup_ngram_min=0)
        for fn in counters.values():
            fn.launches = 0
        _lora_chats(url, texts[3:], LORA_MIXES[3:])
        launches = {k: fn.launches for k, fn in counters.items()}
        if mode == "bf16":
            _, _, logits = served_request(engine, lambda: _lora_chats(
                url, texts[:1], [LORA_A_ONLY]))
            out.update(a_only_logits=logits, a_only_text=texts[0])
        ecfg = dataclasses.replace(engine.ecfg)
        step = Engine(engine.cfg, engine.params, tok, ecfg,
                      device=str(engine.device))
        base = Engine(engine.cfg, _without_lora(engine.params), tok, ecfg,
                      device=str(engine.device))
        if dev.type == "cuda":
            out.update(kernels_a_step=len(step_kernels(step, tmp)),
                       base_kernels_a_step=len(step_kernels(base, tmp)))
        del step
        base.start()
        b_url, close = _serve_engine(routes, base)
        try:
            for _ in range(2):
                _lora_chats(b_url, warm, none)
            _, out["base"] = _rates(base, lambda: _lora_chats(
                b_url, texts, none))
            out["base_graphs_after"] = base.graphs.n_graphs
        finally:
            close()
        out.update(graphs_after=graphs_after,
                   pool_mib=engine.graphs.pool_bytes / 2**20)
    finally:
        _close(engine, srv, thread)
    for k in ("kernels_a_step", "base_kernels_a_step"):
        if k in out:
            out[k.replace("kernels_a_step", "kernels_a_layer")] = \
                out[k] / L
    out.update(texts_alone_equal=alone == mixed, texts_k1_equal=k1 == mixed,
               texts_ngram_equal=ngram == mixed, drafted=drafted,
               mixes_differ=len(set(mixed)) == N_SLOTS,
               launches_one_request=launches)
    log(f"  {mode}: loaded in {load_s:.1f} s; the mixed wave's texts: alone "
        f"= in the wave {out['texts_alone_equal']}, K=1 = K={CHAIN} "
        f"{out['texts_k1_equal']}, n-gram drafts = plain "
        f"{out['texts_ngram_equal']} ({drafted} drafted), four mixes four "
        f"texts {out['mixes_differ']}; captures in the measured wave "
        f"{out['captured_mixed']}, without lora fields "
        f"{out['captured_no_fields']}; graphs after the same waves: LoRA "
        f"{graphs_after}, base {out['base_graphs_after']}")
    log(f"  {mode}: decode tok/s LoRA {out['lora']['decode_tok_s']:.1f} / "
        f"base {out['base']['decode_tok_s']:.1f}; TTFT p50 ms "
        f"{out['lora']['ttft_p50_ms']:.2f} / "
        f"{out['base']['ttft_p50_ms']:.2f}; prefill tok/s "
        f"{out['lora']['prefill_tok_s']:.1f} / "
        f"{out['base']['prefill_tok_s']:.1f}; kernels a layer a decode step "
        f"{out.get('kernels_a_layer', float('nan')):.2f} / "
        f"{out.get('base_kernels_a_layer', float('nan')):.2f}; launches of "
        f"one LoRA request {launches}")
    assert out["texts_alone_equal"], (mode, "a slot's text in the wave "
                                      "differs from the request alone")
    assert out["texts_k1_equal"], (mode, f"K=1 and K={CHAIN} differ")
    assert out["texts_ngram_equal"], (mode, "n-gram drafts change the text")
    for k, n in launches.items():
        if k in LORA_KERNELS[mode]:
            assert n > 0, f"{k} was never launched ({mode}, LoRA)"
        else:
            assert n == 0, f"{k} launched ({mode}, LoRA)"
    return out


def served_one(dev, mode, extra, text) -> dict:
    """One greedy chat of `text` on a fresh server of phase 5's `mode`
    file with `extra` flags, alone: its first answer token's logits as
    the engine's prefill program computed them, its prompt ids, the
    kernels it launched, the load seconds."""
    engine, srv, url, thread, load_s = _lora_server(dev, mode, extra)
    counters = kernel_counters()
    try:
        _lora_chats(url, [text[::-1]], [None])        # first uses, eager
        for fn in counters.values():
            fn.launches = 0
        _, task, logits = served_request(
            engine, lambda: _lora_chats(url, [text], [None]))
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        _close(engine, srv, thread)
    return dict(logits=logits, ids=task.prompt_tokens, launches=launches,
                load_s=load_s)


def lora_phase(dev, seed, tmp) -> dict:
    """Phase 16 (see the module docstring)."""
    from llama_box_tpu_torch.models.control_vector import \
        combine_control_vectors
    from llama_box_tpu_torch.models.loader import load_model
    from llama_box_tpu_torch.models.lora import apply_lora, load_lora
    log("== phase 16: LoRA adapters and a control vector (TinyLlama "
        "widths, phase 5's files)")
    t_phase = time.perf_counter()
    _LORA_FILES.update(
        model={m: _model_path(tmp, PATHS[m][1]) for m in PATHS},
        a=f"{tmp}/lora-a.gguf", b=f"{tmp}/lora-b.gguf",
        c=f"{tmp}/cvec-c.gguf")
    for name in LORA_ADAPTERS:
        write_lora(_LORA_FILES[name], name, seed)
    write_cvec(_LORA_FILES["c"], seed)
    out: dict = {}
    for mode in PATHS:
        out[mode] = lora_serve(dev, seed, tmp, mode)
        if mode == "q4":
            os.remove(_LORA_FILES["model"][mode])
    # 16b: the static merge on bf16, and the dynamic path at a's default
    # scale, each against the f32 host forward of the merged weights
    log("== phase 16b: --lora a (merged) on bf16, against the f32 host "
        "forward")
    text = out["bf16"].pop("a_only_text")
    dyn = out["bf16"].pop("a_only_logits")
    static = served_one(dev, "bf16", ["--lora", _LORA_FILES["a"]], text)
    cfg, host = load_model(_LORA_FILES["model"]["bf16"], dtype=torch.float32,
                           device="cpu")
    ids = static["ids"]
    blk, out_pair = load_lora(_LORA_FILES["a"]), load_lora(_LORA_FILES["a"])
    blk.pairs = {k: v for k, v in blk.pairs.items() if k.startswith("blk.")}
    out_pair.pairs = {"output.weight": out_pair.pairs["output.weight"]}
    merged_blk = apply_lora(dict(host, layers=dict(host["layers"])), cfg,
                            [blk])
    merged = apply_lora(dict(merged_blk), cfg, [out_pair])
    want, want_blk, want_base = (_host_logits(p, cfg, ids)
                                 for p in (merged, merged_blk, host))
    cv = combine_control_vectors([(_LORA_FILES["c"], float(CVEC_SCALE))],
                                 cfg.n_layers, cfg.n_embd,
                                 layer_range=tuple(map(int, CVEC_RANGE)))
    want_cv = _host_logits(dict(host, cvec=torch.from_numpy(cv)), cfg, ids)
    del host, merged, merged_blk
    out["static"] = dict(
        cos_static_host=_cos1(static["logits"], want),
        cos_dynamic_host=_cos1(dyn, want_blk),
        cos_dynamic_static=_cos1(dyn, static["logits"]),
        cos_host_merged_base=_cos1(want, want_base),
        load_s=static["load_s"])
    s = out["static"]
    log(f"  the served first answer token's logits: static merge vs the "
        f"f32 host merge {s['cos_static_host']:.6f}; dynamic (a at 1.0, b "
        f"off) vs the f32 host merge of a's layer pairs "
        f"{s['cos_dynamic_host']:.6f} (the dynamic path leaves "
        f"output.weight's pair out, as JAX's stack_dynamic); dynamic vs "
        f"static {s['cos_dynamic_static']:.6f}; the host's merge vs its "
        f"base {s['cos_host_merged_base']:.6f} (what a moves)")
    assert s["cos_static_host"] >= LORA_COS, s
    assert s["cos_dynamic_host"] >= LORA_COS, s
    # 16c: the control vector on bf16 and w8a8
    log("== phase 16c: --control-vector-scaled c 0.8 "
        "--control-vector-layer-range 2 3, against the f32 host forward")
    cflags = ["--control-vector-scaled", _LORA_FILES["c"], CVEC_SCALE,
              "--control-vector-layer-range", *CVEC_RANGE]
    out["cvec"] = {}
    for mode in ("bf16", "w8a8"):
        r = served_one(dev, mode, cflags, text)
        assert mode != "bf16" or r["ids"] == ids
        x = {}
        if mode == "w8a8":
            cfg, host = load_model(_LORA_FILES["model"][mode],
                                   dtype=torch.float32, device="cpu")
            want_cv = _host_logits(dict(host, cvec=torch.from_numpy(cv)),
                                   cfg, r["ids"])
            want_base = _host_logits(host, cfg, r["ids"])
            del host
            cfg, host = load_model(_LORA_FILES["model"][mode],
                                   dtype=torch.bfloat16, device="cpu",
                                   quantized=True)
            plain = _host_logits(dict(host, cvec=torch.from_numpy(cv).to(
                torch.bfloat16)), cfg, r["ids"], torch.bfloat16)
            del host
            os.remove(_LORA_FILES["model"][mode])
            x.update(cos_plain=_cos1(r["logits"], plain),
                     cos_plain_f32=_cos1(plain, want_cv))
        x.update(cos_host=_cos1(r["logits"], want_cv),
                 cos_host_steered_base=_cos1(want_cv, want_base),
                 launches_one_request=r["launches"], load_s=r["load_s"])
        out["cvec"][mode] = x
        log(f"  {mode}: served vs the f32 host forward with the vector "
            f"{x['cos_host']:.6f}"
            + f" (tol {CVEC_COS[mode]})"
            + (f", vs the plain versions on the host over the same QTensors "
               f"{x['cos_plain']:.6f} (tol {CVEC_PLAIN_COS}; those vs f32 "
               f"{x['cos_plain_f32']:.6f})" if "cos_plain" in x else "")
            + f"; the host's steered vs unsteered "
            f"{x['cos_host_steered_base']:.6f}; launches of the request "
            f"{r['launches']}")
        assert x["cos_host"] >= CVEC_COS[mode], (mode, x)
        assert x.get("cos_plain", 1.0) >= CVEC_PLAIN_COS, (mode, x)
        if mode == "w8a8":
            assert r["launches"]["fused_norm_qmm"] > 0 \
                and r["launches"]["fused_layer_tail"] > 0, \
                "the fused w8a8 kernels did not run under a control vector"
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# --families: jetmoe's mixture of attention and openelm's per-layer
# geometry at published widths, on phase 11's machinery

def _openelm_dims() -> dict:
    """apple/OpenELM-270M's per-layer geometry as its config builds it:
    16 layers, model_dim 1280, head_dim 64, 4 query heads a KV head, qkv
    multipliers 0.5 to 1.0 and FFN multipliers 0.5 to 4.0 (linear over
    the layers), each width made divisible by 256 (never below 0.9 of
    it)."""
    def divisible(v, d=256):
        n = max(d, int(v + d / 2) // d * d)
        return n + d if n < 0.9 * v else n
    L_, E_, D_ = 16, 1280, 64
    q = [divisible(E_ * (0.5 + 0.5 * i / (L_ - 1))) // D_ for i in range(L_)]
    ffs = [divisible(E_ * (0.5 + 3.5 * i / (L_ - 1))) for i in range(L_)]
    return dict(hc=q, hk=[h // 4 for h in q], ffs=ffs)


FAMILY_VARIANTS = {
    # jetmoe/jetmoe-8b config.json: 24 x 2048, 16 KV heads of 128
    # (kv_channels), 8 attention experts and 8 FFN experts with 2 a token,
    # FF 5632, vocab 32000, rope base 1e4, rms eps 1e-5; the GGUF's
    # head_count is X x head_count_kv (every expert's query heads, the JAX
    # package's convention); depth cut from 24 to 2 layers
    "jetmoe-8b": dict(arch="jetmoe", L=2, E=2048, H=128, HKV=16, D=128,
                      FF=5632, X=8, K=2, V=32000, rot=128, eps=1e-5,
                      base=10000.0, ctx=4096),
    # apple/OpenELM-270M: 16 x 1280, head dim 64, 12 to 20 query heads and
    # 3 to 5 KV heads a layer, FFN widths 768 to 5120, vocab 32000, tied
    # embeddings, per-head q/k norms, rms eps 1e-6; every layer
    "openelm-270m": dict(arch="openelm", L=16, E=1280, H=20, HKV=5, D=64,
                         FF=5120, V=32000, rot=64, eps=1e-6, base=10000.0,
                         ctx=2048, **_openelm_dims()),
}
FAMILY_PATHS = {
    "bf16": ([], {"jetmoe-8b": ("row_norm", "flash_prefill", "flash_decode",
                                "moe_ffn"),
                  "openelm-270m": ("row_norm", "flash_prefill",
                                   "flash_decode")}),
}


def family_phase(dev, seed, tmp) -> dict:
    """--families (see the module docstring)."""
    from llama_box_tpu_torch.models.loader import load_model
    log("== families: " + ", ".join(FAMILY_VARIANTS))
    t_phase = time.perf_counter()
    out = {}
    for name in FAMILY_VARIANTS:
        path = f"{tmp}/synthetic-{name}-q8_0.gguf"
        t0 = time.perf_counter()
        write_variant(path, name, seed)
        cfg, params = load_model(path, dtype=torch.float32, device="cpu")
        ref = small_forward(params, cfg, "cpu", torch.float32)
        del params
        log(f"  {name}: written and its f32 forward on the host in "
            f"{time.perf_counter() - t0:.1f} s; {cfg.n_layers} layers, "
            f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim} "
            f"(padded), FF {cfg.n_ff}")
        out[name] = {mode: variant_serve(dev, seed, tmp, name, path, mode,
                                         ref, paths=FAMILY_PATHS)
                     for mode in FAMILY_PATHS}
        os.remove(path)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  families: {out['seconds']:.1f} s")
    return out


def depth_check(dev, seed, tmp, name, n_layers) -> dict:
    """--depth-check: VARIANTS[name] at n_layers on the w8a8 path, layer by
    layer. small_forward's first pass through the card's kernels, through
    the plain versions on the host over the same QTensors (bf16
    activations), and in f32 on the host over the file; each layer's
    residual stream compared by its lowest row cosine. The first layer
    where the card leaves the plain versions (below 0.9999) is where a
    kernel parts from its definition; a card that follows them while both
    drift from f32 layer by layer shows the path's rounding."""
    from llama_box_tpu_torch.models import llama
    from llama_box_tpu_torch.models.loader import (deinterleave_rope,
                                                   fuse_projections,
                                                   load_model)
    log(f"== depth check: {name} at {n_layers} layers, w8a8")
    path = f"{tmp}/synthetic-{name}-{n_layers}-q8_0.gguf"
    write_variant(path, name, seed, n_layers)

    def fused(cfg, params):
        params, cfg = deinterleave_rope(params, cfg)
        return cfg, fuse_projections(params, cfg)

    def layers_of(params, cfg, device, kv_dtype):
        seen = []
        inner = llama._attn_layer

        def spy(*a, **k):
            x = inner(*a, **k)
            seen.append(x.float().cpu())
            return x
        llama._attn_layer = spy
        try:
            logits = small_forward(params, cfg, device, kv_dtype)
        finally:
            llama._attn_layer = inner
        return seen[:cfg.n_layers], logits

    cfg, host = fused(*load_model(path, dtype=torch.float32, device="cpu"))
    want, want_lg = layers_of(host, cfg, "cpu", torch.float32)
    del host
    cfg, card = fused(*load_model(path, dtype=torch.bfloat16, device=dev,
                                  quantized=True))
    got, got_lg = layers_of(card, cfg, dev, torch.bfloat16)
    plain, plain_lg = layers_of(_moved(card, "cpu"), cfg, "cpu",
                                torch.bfloat16)
    os.remove(path)

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(
            a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])).min())
    card_f32 = [cos(g, w) for g, w in zip(got, want)]
    card_plain = [cos(g, p) for g, p in zip(got, plain)]
    plain_f32 = [cos(p, w) for p, w in zip(plain, want)]
    parting = next((i for i, c in enumerate(card_plain) if c < 0.9999), None)
    out = dict(layers=n_layers, card_f32=card_f32, card_plain=card_plain,
               plain_f32=plain_f32, first_parting_layer=parting,
               logits_card_f32=_cosine(got_lg, want_lg),
               logits_card_plain=_cosine(got_lg, plain_lg),
               logits_plain_f32=_cosine(plain_lg, want_lg))
    log(f"  residual stream min row cosine a layer, card vs f32: "
        + " ".join(f"{c:.6f}" for c in card_f32))
    log(f"  card vs the plain versions: "
        + " ".join(f"{c:.6f}" for c in card_plain))
    log(f"  plain versions vs f32: " + " ".join(f"{c:.6f}" for c in plain_f32))
    log(f"  logits (small_forward's 6 rows, min cosine): card vs f32 "
        f"{out['logits_card_f32']:.6f}, card vs plain "
        f"{out['logits_card_plain']:.6f}, plain vs f32 "
        f"{out['logits_plain_f32']:.6f}; first layer where the card leaves "
        f"the plain versions: {parting}")
    return out


# ---------------------------------------------------------------------------
# the recurrent kernels (csrc/ssm_scan.cu, csrc/wkv.cu): phases 3r and 4r

# label -> (slots S, rows T, channels C, steps a row nh, B/C groups G,
# states ds, a decay per state): the rows phase 17 gives the selective
# scan (Mamba-1.4B's mixer, and granite-4.0-h-micro's behind --families:
# a 4 x 512 prefill, 4 decode rows) and Jamba2-3B's mixer (5120 channels)
SSM_CASES = {
    "mamba-1.4b 4x512 prefill": (4, 512, 4096, 4096, 1, 16, True),
    "mamba-1.4b 4 decode rows": (4, 1, 4096, 4096, 1, 16, True),
    "jamba2-3b 4x512 prefill": (4, 512, 5120, 5120, 1, 16, True),
    "granite-4.0-h-micro 4x512 prefill": (4, 512, 4096, 64, 1, 128, False),
    "granite-4.0-h-micro 4 decode rows": (4, 1, 4096, 64, 1, 128, False),
}
# label -> (rule, S, T, heads H, k-heads Hk, state width N): RWKV-7-1.5B's
# and RWKV-6-1.6B's 32 heads of 64, qwen3-next's delta rule (32 v-heads
# over 16 k-heads of 128)
WKV_CASES = {
    "rwkv7 h32x64 4x512 prefill": ("wkv7", 4, 512, 32, 32, 64),
    "rwkv7 h32x64 4 decode rows": ("wkv7", 4, 1, 32, 32, 64),
    "rwkv6 h32x64 4x512 prefill": ("wkv6", 4, 512, 32, 32, 64),
    "delta 32/16x128 4x512 prefill": ("delta", 4, 512, 32, 16, 128),
    "delta 32/16x128 4 decode rows": ("delta", 4, 1, 32, 16, 128),
}
# the case each kernel's row of the kernels line reports
REC_MAIN = {"ssm_scan": "mamba-1.4b 4x512 prefill",
            "wkv": "rwkv7 h32x64 4x512 prefill"}
REC_REL = 1e-5      # kernel vs plain, x max|plain| (f32 sums reordered)
# each state element's operations a row (multiply-adds and the exp the
# update takes; the output's product and sum)
SSM_OPS, WKV_OPS = {True: 7, False: 5}, {"wkv6": 6, "wkv7": 8, "delta": 7}


def _rec_lens(S, T, dev):
    """Valid rows a slot: whole, part, none (its state NaN: must keep its
    bits), one."""
    return torch.tensor([T, max(1, T * 3 // 5), 0, 1][:S], device=dev)


def _ssm_case(g, dev, label):
    S, T, C, nh, G, ds, per_state = SSM_CASES[label]

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s
    inp = dict(x=r(S, T, C), dt=torch.nn.functional.softplus(r(S, T, nh)
                                                             - 2.0),
               A=-torch.exp(r(C, ds) if per_state else r(nh)),
               B=r(S, T, G, ds), Cm=r(S, T, G, ds), D=r(nh))
    return inp, r(S, C, ds, s=0.5)


def _ssm_run(fn, inp, lens, state, a=0, b=None):
    sub = {k: (v[:, a:b] if k in ("x", "dt", "B", "Cm") else v)
           for k, v in inp.items()}
    return fn(sub["x"].contiguous(), sub["dt"].contiguous(), sub["A"],
              sub["B"].contiguous(), sub["Cm"].contiguous(), sub["D"], lens,
              state)


def _wkv_case(g, dev, label):
    mode, S, T, H, Hk, N = WKV_CASES[label]
    F = torch.nn.functional

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s
    if mode == "delta":
        args = (F.normalize(r(S, T, Hk, N), dim=-1),
                F.normalize(r(S, T, Hk, N), dim=-1), r(S, T, H, N),
                torch.sigmoid(r(S, T, H) + 2.0), torch.sigmoid(r(S, T, H)))
    elif mode == "wkv6":
        args = (r(S, T, H, N), r(S, T, H, N, s=0.3), r(S, T, H, N, s=0.3),
                torch.exp(-torch.exp(r(S, T, H, N) - 1.0)), r(H, N, s=0.3))
    else:
        args = (r(S, T, H, N), torch.exp(-torch.exp(r(S, T, H, N) - 1.0)),
                r(S, T, H, N, s=0.3), r(S, T, H, N, s=0.3),
                F.normalize(r(S, T, H, N), dim=-1),
                torch.sigmoid(r(S, T, H, N)))
    return mode, args, r(S, H, N, N, s=0.3)


def _wkv_fns(mode):
    from llama_box_tpu_torch.ops import wkv
    name = "delta_rule" if mode == "delta" else mode
    return getattr(wkv, name), getattr(wkv, name + "_plain")


def _wkv_rows(mode, args, a, b):
    return tuple(t if (mode == "wkv6" and i == 4) else t[:, a:b].contiguous()
                 for i, t in enumerate(args))


def _rec_compare(label, y, want, st, st_plain, lens) -> float:
    """The kernel's valid rows and states against the plain version's
    (within REC_REL x max|plain|); the masked slot's NaN state intact."""
    rows = [int(n) for n in lens.tolist()]
    masked = rows.index(0)
    assert torch.isnan(st[masked]).all(), f"{label}: a masked state moved"
    err = 0.0
    for b, n in enumerate(rows):
        if not n:
            continue
        e = float((y[b, :n] - want[b, :n]).abs().max())
        tol = REC_REL * float(want[b, :n].abs().max())
        assert e <= tol and torch.isfinite(y[b, :n]).all(), (label, b, e)
        es = float((st[b] - st_plain[b]).abs().max())
        assert es <= REC_REL * float(st_plain[b].abs().max()), (label, b, es)
        err = max(err, e)
    return err


def rec_kernel_phase(dev, seed):
    """Phase 3r: both recurrent kernels against their plain versions at
    SSM_CASES / WKV_CASES (slots of seq_lens T, a part of T, 0 with a NaN
    state that must keep its bits, and 1), within REC_REL x max|plain|;
    a prefill split as P + 1 + the rest bit-equal (outputs and state) to
    the whole, which also holds the one-row step against the row after a
    P-row prefill. Phase 4r: their device times on a cold L2 beside the
    bound (inputs, outputs and the state read and written once, over 3.35
    TB/s; or the f32 operations over 67 TFLOP/s) and the plain version's
    time; no PyTorch call computes either function."""
    from llama_box_tpu_torch.ops import ssm_scan as ss
    from llama_box_tpu_torch.ops import wkv
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 23)
    log("== phase 3r: the selective scan (csrc/ssm_scan.cu) and the WKV "
        "rules (csrc/wkv.cu) vs plain")
    errs = {"ssm_scan": 0.0, "wkv": 0.0}
    timed = []
    for label in SSM_CASES:
        S, T, C, nh, G, ds, per_state = SSM_CASES[label]
        inp, s0 = _ssm_case(g, dev, label)
        lens = _rec_lens(S, T, dev)
        s0[lens.tolist().index(0)] = float("nan")
        st, stp = s0.clone(), s0.clone()
        before = ss.ssm_scan.launches
        y = _ssm_run(ss.ssm_scan, inp, lens, st)
        want = _ssm_run(ss.ssm_scan_plain, inp, lens, stp)
        torch.cuda.synchronize()
        assert ss.ssm_scan.launches == before + 1
        e = _rec_compare(label, y, want, st, stp, lens)
        errs["ssm_scan"] = max(errs["ssm_scan"], e)
        full = torch.full((S,), T, device=dev)
        st1, st2 = s0.clone(), s0.clone()
        st1[2] = st2[2] = 0.0
        whole = _ssm_run(ss.ssm_scan, inp, full, st1)
        P = max(1, T * 3 // 5) if T > 2 else T
        cuts = [(0, P), (P, P + 1), (P + 1, T)] if T > 2 else [(0, T)]
        parts = torch.cat([_ssm_run(ss.ssm_scan, inp, torch.full_like(
            full, b - a), st2, a, b) for a, b in cuts], dim=1)
        bits = torch.equal(parts, whole) and torch.equal(st1, st2)
        log(f"  ssm_scan {label:<36s} max_abs_err {e:.3e} (tol {REC_REL:g}"
            f" x max|plain|); split {cuts} = whole bit for bit: {bits}")
        assert bits, label
        rows_v = int(lens.sum())
        nbytes = 4 * (S * T * (2 * C + nh + 2 * G * ds) + 2 * S * C * ds
                      + inp["A"].numel() + nh)
        timed.append(("ssm_scan", label, lambda i=inp, l=lens, s=st:
                      _ssm_run(ss.ssm_scan, i, l, s.clone()),
                      lambda i=inp, l=lens, s=st:
                      _ssm_run(ss.ssm_scan_plain, i, l, s.clone()),
                      nbytes, SSM_OPS[per_state] * rows_v * C * ds))
    for label in WKV_CASES:
        mode, S, T, H, Hk, N = WKV_CASES[label]
        _, args, s0 = _wkv_case(g, dev, label)
        fn, plain = _wkv_fns(mode)
        lens = _rec_lens(S, T, dev)
        s0[lens.tolist().index(0)] = float("nan")
        st, stp = s0.clone(), s0.clone()
        before = wkv.wkv_kernel.launches
        y = fn(*args, lens, st)
        want = plain(*args, lens, stp)
        torch.cuda.synchronize()
        assert wkv.wkv_kernel.launches == before + 1
        e = _rec_compare(label, y, want, st, stp, lens)
        errs["wkv"] = max(errs["wkv"], e)
        full = torch.full((S,), T, device=dev)
        st1, st2 = s0.clone(), s0.clone()
        st1[2] = st2[2] = 0.0
        whole = fn(*args, full, st1)
        P = max(1, T * 3 // 5) if T > 2 else T
        cuts = [(0, P), (P, P + 1), (P + 1, T)] if T > 2 else [(0, T)]
        parts = torch.cat([fn(*_wkv_rows(mode, args, a, b),
                              torch.full_like(full, b - a), st2)
                           for a, b in cuts], dim=1)
        bits = torch.equal(parts, whole) and torch.equal(st1, st2)
        log(f"  wkv {mode:<5s} {label:<33s} max_abs_err {e:.3e} (tol "
            f"{REC_REL:g} x max|plain|); split = whole bit for bit: {bits}")
        assert bits, label
        nvec = {"wkv6": 4, "wkv7": 6, "delta": 1}[mode]
        nbytes = 4 * (S * T * H * N * (nvec + 1)
                      + (2 * S * T * Hk * N + 2 * S * T * H
                         if mode == "delta" else 0)
                      + 2 * S * H * N * N + (H * N if mode == "wkv6" else 0))
        timed.append(("wkv", label, lambda a=args, l=lens, s=st, f=fn:
                      f(*a, l, s.clone()),
                      lambda a=args, l=lens, s=st, f=plain: f(*a, l,
                                                             s.clone()),
                      nbytes, WKV_OPS[mode] * int(lens.sum()) * H * N * N))

    log("== phase 4r: ssm_scan and wkv device times (median of 15, a "
        "plain version's of 5, cold L2)")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for kind, label, kern, plain, nbytes, flops in timed:
        b_ms, b_by = bound_ms(nbytes, flops, F32_FLOPS)
        r = dict(kind=kind, case=label, ms=device_ms(kern, flush),
                 plain_ms=device_ms(plain, flush, n=PLAIN_REPS),
                 library_ms=None,
                 library="no PyTorch call", bound_ms=b_ms, bound_by=b_by,
                 mbytes=nbytes / 1e6, gflop=flops / 1e9)
        rows.append(r)
        log("  " + json.dumps(r))
    return errs, rows


# ---------------------------------------------------------------------------
# phase 17: the recurrent families at published widths

REC_VARIANTS = {
    # state-spaces/mamba-1.4b-hf config.json: 48 x 2048, d_inner 4096
    # (expand 2), d_state 16, dt_rank 128, conv 4, vocab 50280, tied
    # embeddings, rms eps 1e-5; depth cut from 48 to 8 layers
    "mamba-1.4b": dict(arch="mamba", L=8, E=2048, DI=4096, DS=16, DTR=128,
                       DC=4, V=50280, eps=1e-5),
    # fla-hub/rwkv7-1.5B-world: 24 x 2048, head 64, FF 8192, LoRA ranks w
    # 96 / a 96 / v 64 / g 256, vocab 65536; depth cut to 4 layers
    "rwkv7-1.5b": dict(arch="rwkv7", L=4, E=2048, HS=64, FF=8192, W=96,
                       A=96, VR=64, G=256, V=65536, eps=1e-5),
}
REC_FAMILY_VARIANTS = {
    # ibm-granite/granite-4.0-h-micro config.json: 40 x 2048, mamba2 64
    # heads of 64 (d_inner 4096), d_state 128, 1 group, conv 4, attention
    # (32 / 8 heads of 64, rope base 1e4) at layers 5, 15, 25, 35, FF 8192,
    # vocab 100352, embedding / residual / logits multipliers 12 / 0.22 / 8
    # (the logits divided by 8), tied; its first 6 layers (attention at
    # 5); served behind --families, outside the default run's time
    "granite-4.0-h-micro": dict(arch="granitehybrid", L=6, E=2048, DI=4096,
                                DS=128, NH=64, NG=1, DC=4, H=32, HKV=8,
                                D=64, ATTN=(5,), FF=8192, V=100352, eps=1e-5,
                                base=10000.0, escale=12.0, rscale=0.22,
                                lscale=0.125),
    # RWKV/v6-Finch-1B6-HF: 24 x 2048, head 64, FF 7168, mix / decay LoRA
    # 32 / 64, vocab 65536; 4 of 24 layers
    "rwkv6-1.6b": dict(arch="rwkv6", L=4, E=2048, HS=64, FF=7168, MIX=32,
                       DEC=64, V=65536, eps=1e-5),
    # Qwen/Qwen3-Next-80B-A3B-Instruct config.json: 48 x 2048, every 4th
    # layer gated attention (16 / 2 heads of 256, partial rotary 0.25, rope
    # base 1e7), the others gated DeltaNet (16 k-heads / 32 v-heads of 128,
    # conv 4), 512 experts, 10 a token, expert FF 512, one shared expert of
    # 512, vocab 151936, rms eps 1e-6; its first 4 layers
    "qwen3-next-80b-a3b": dict(arch="qwen3next", L=4, E=2048, H=16, HKV=2,
                               D=256, rot=64, HK=16, HV=32, DK=128, DV=128,
                               DC=4, X=512, K=10, FFE=512, SH=512, FF=5120,
                               V=151936, eps=1e-6, base=1e7),
    # ai21labs/AI21-Jamba2-3B config.json: 28 x 2560, mamba d_state 16,
    # dt_rank 160, expand 2 (d_inner 5120), conv 4, 20 / 1 heads of 128,
    # attention at layer 7, FF 8192, vocab 65536; its first 8 layers
    "jamba2-3b": dict(arch="jamba", L=8, E=2560, DI=5120, DS=16, DTR=160,
                      DC=4, H=20, HKV=1, D=128, ATTN=(7,), FF=8192, V=65536,
                      eps=1e-6),
}
REC_DEFAULT = tuple(REC_VARIANTS)
# each phase 17 path: CLI flags, and the kernels one request must launch
REC_PATHS = {
    "bf16": ([], {"mamba-1.4b": ("row_norm", "ssm_scan"),
                  "granite-4.0-h-micro": ("row_norm", "ssm_scan",
                                          "flash_prefill", "flash_decode"),
                  "rwkv7-1.5b": ("row_norm", "wkv"),
                  "rwkv6-1.6b": ("row_norm", "wkv"),
                  "qwen3-next-80b-a3b": ("row_norm", "wkv", "flash_prefill",
                                         "flash_decode", "moe_ffn")}),
    "w8a8": (["--weights-dtype", "quantized"],
             {"mamba-1.4b": ("row_norm", "ssm_scan", "w8a8_matmul")}),
}
# which models take which paths (the rest of REC_PATHS' rows: bf16 only)
REC_MODES = {"mamba-1.4b": ("bf16", "w8a8")}
# rec_small_forward's logits on the card against the f32 host forward of
# the file, by path; on w8a8 also against the plain versions on the host
# over the same QTensors (int8 activations a row drift from f32 through
# the mixers' exp and softplus: the plain versions show the same drift)
REC_COS = {"bf16": VARIANT_COS, "w8a8": 0.97}
REC_PLAIN_COS = 0.99    # w8a8_reference_check's gate
# the turn that extends the first exactly: 1 + 4 + 16 + 16 tokens fill the
# ramped chains (4, then 16) with no tail cut, so the state stays clean
REC_TURN_TOKENS = 37


def write_rec_variant(path: str, name: str, seed: int) -> None:
    """The synthetic GGUF of REC_VARIANTS[name] (or REC_FAMILY_VARIANTS'),
    in the tensor conventions of tests/fixtures/make_tiny_mamba.py and
    make_tiny_rwkv.py (llama.cpp's converters): Q8_0 matrices, F32
    vectors, the mixers' smalls (conv, A, D, norms, lerps) F32, random
    from `seed`; a synthetic vocabulary of the published size and the
    chatml template."""
    from llama_box_tpu_torch.gguf import GGMLType, GGUFWriter
    c = {**REC_VARIANTS, **REC_FAMILY_VARIANTS}[name]
    a, L_, E_, V_ = c["arch"], c["L"], c["E"], c["V"]
    rng = np.random.default_rng(seed + 171)
    vocab, scores, types = spm_vocab(V_)
    w = GGUFWriter(path, architecture=a)
    hkv = [c["HKV"] if i in c.get("ATTN", ()) else 0 for i in range(L_)]
    kvs = [("block_count", L_), ("context_length", 8192),
           ("embedding_length", E_), ("vocab_size", V_),
           ("attention.layer_norm_rms_epsilon", c["eps"]),
           ("attention.layer_norm_epsilon", c["eps"])]
    if "DI" in c:
        kvs += [("ssm.conv_kernel", c["DC"]), ("ssm.inner_size", c["DI"]),
                ("ssm.state_size", c["DS"]),
                ("ssm.time_step_rank", c.get("DTR", c.get("NH"))),
                ("feed_forward_length", c.get("FF", 0))]
    if "NG" in c:
        kvs.append(("ssm.group_count", c["NG"]))
    if "H" in c and a != "qwen3next":
        kvs += [("attention.head_count", c["H"]),
                ("attention.head_count_kv", hkv),
                ("attention.key_length", c["D"]),
                ("attention.value_length", c["D"]),
                ("rope.freq_base", c.get("base", 10000.0)),
                ("rope.dimension_count", c["D"])]
    if a == "granitehybrid":
        kvs += [("embedding_scale", c["escale"]),
                ("residual_scale", c["rscale"]),
                ("logit_scale", c["lscale"])]
    if "HS" in c:
        kvs += [("feed_forward_length", c["FF"]), ("wkv.head_size", c["HS"]),
                ("attention.head_count", 0), ("attention.head_count_kv", 0),
                ("rescale_every_n_layers", 0), ("token_shift_count", 2)]
    if a == "qwen3next":
        kvs += [("feed_forward_length", c["FF"]),
                ("attention.head_count", c["H"]),
                ("attention.head_count_kv", c["HKV"]),
                ("attention.key_length", c["D"]),
                ("attention.value_length", c["D"]),
                ("rope.freq_base", c["base"]),
                ("rope.dimension_count", c["rot"]),
                ("expert_count", c["X"]), ("expert_used_count", c["K"]),
                ("expert_feed_forward_length", c["FFE"]),
                ("expert_shared_feed_forward_length", c["SH"]),
                ("expert_weights_norm", True),
                ("ssm.conv_kernel", c["DC"]),
                ("ssm.inner_size", c["HV"] * c["DV"]),
                ("ssm.state_size", c["DK"]),
                ("ssm.time_step_rank", c["HV"]),
                ("ssm.group_count", c["HK"])]
    for k, v in kvs:
        w.add_kv(f"{a}.{k}", v)
    for k, v in (("general.name", f"synthetic-{name}"),
                 ("tokenizer.ggml.model", "llama"),
                 ("tokenizer.ggml.tokens", vocab),
                 ("tokenizer.ggml.scores", np.asarray(scores, np.float32)),
                 ("tokenizer.ggml.token_type", np.asarray(types, np.int32)),
                 ("tokenizer.ggml.bos_token_id", 1),
                 ("tokenizer.ggml.eos_token_id", 2),
                 ("tokenizer.ggml.unknown_token_id", 0),
                 ("tokenizer.ggml.add_bos_token", True),
                 ("tokenizer.chat_template", CHATML)):
        w.add_kv(k, v)
    q8 = GGMLType.Q8_0

    def mat(tname, *shape):
        w.add_raw_tensor(tname, shape, q8, _q8_random(rng, shape))

    def vec(tname, *shape, base=0.0, s=0.02):
        w.add_tensor(tname, (base + rng.standard_normal(
            shape, dtype=np.float32) * s).astype(np.float32))

    mat("token_embd.weight", V_, E_)
    if "HS" in c:
        vec("token_embd_norm.weight", E_, base=1.0)
        vec("token_embd_norm.bias", E_)
    vec("output_norm.weight", E_, base=1.0)
    if "HS" in c:
        vec("output_norm.bias", E_)
    if a in ("rwkv7", "rwkv6", "qwen3next", "jamba"):
        mat("output.weight", V_, E_)     # mamba and granite tie theirs
    for i in range(L_):
        p = f"blk.{i}."
        vec(p + "attn_norm.weight", E_, base=1.0)
        if "HS" in c:
            _rwkv_layer(c, p, i, mat, vec)
            continue
        if a == "qwen3next":
            _qwen3next_layer(c, p, i, mat, vec, rng, w)
            continue
        vec(p + "ffn_norm.weight", E_, base=1.0) if "FF" in c and c["FF"] \
            else None
        if i in c.get("ATTN", ()):
            H_, HKV_, D_ = c["H"], c["HKV"], c["D"]
            mat(p + "attn_q.weight", H_ * D_, E_)
            mat(p + "attn_k.weight", HKV_ * D_, E_)
            mat(p + "attn_v.weight", HKV_ * D_, E_)
            mat(p + "attn_output.weight", E_, H_ * D_)
        elif "NH" in c:                   # mamba2 (granite)
            di, ds, ng, nh, dc = c["DI"], c["DS"], c["NG"], c["NH"], c["DC"]
            conv_dim = di + 2 * ng * ds
            mat(p + "ssm_in.weight", 2 * di + 2 * ng * ds + nh, E_)
            vec(p + "ssm_conv1d.weight", conv_dim, dc, s=0.3)
            vec(p + "ssm_conv1d.bias", conv_dim)
            vec(p + "ssm_dt.bias", nh, base=0.5, s=0.1)
            w.add_tensor(p + "ssm_a.weight", -(1.0 + rng.uniform(
                0.0, 3.0, nh)).astype(np.float32))
            vec(p + "ssm_d.weight", nh, base=1.0)
            vec(p + "ssm_norm.weight", di, base=1.0)
            mat(p + "ssm_out.weight", E_, di)
        else:                             # mamba1 (mamba, jamba)
            di, ds, dtr, dc = c["DI"], c["DS"], c["DTR"], c["DC"]
            mat(p + "ssm_in.weight", 2 * di, E_)
            vec(p + "ssm_conv1d.weight", di, dc, s=0.3)
            vec(p + "ssm_conv1d.bias", di)
            mat(p + "ssm_x.weight", dtr + 2 * ds, di)
            mat(p + "ssm_dt.weight", di, dtr)
            vec(p + "ssm_dt.bias", di, base=0.5, s=0.1)
            w.add_tensor(p + "ssm_a.weight", -(1.0 + rng.uniform(
                0.0, 3.0, (di, ds))).astype(np.float32))
            vec(p + "ssm_d.weight", di, base=1.0)
            mat(p + "ssm_out.weight", E_, di)
            if a == "jamba":
                vec(p + "ssm_dt_norm.weight", dtr, base=1.0)
                vec(p + "ssm_b_norm.weight", ds, base=1.0)
                vec(p + "ssm_c_norm.weight", ds, base=1.0)
        if c.get("FF"):
            mat(p + "ffn_gate.weight", c["FF"], E_)
            mat(p + "ffn_up.weight", c["FF"], E_)
            mat(p + "ffn_down.weight", E_, c["FF"])
    w.write()


def _rwkv_layer(c, p, i, mat, vec):
    """One rwkv6 / rwkv7 layer (make_tiny_rwkv.py's tensors)."""
    E_, HS, FF_ = c["E"], c["HS"], c["FF"]
    H_ = E_ // HS
    t = p + "time_mix_"
    vec(p + "attn_norm.bias", E_)
    vec(p + "attn_norm_2.weight", E_, base=1.0)
    vec(p + "attn_norm_2.bias", E_)
    if c["arch"] == "rwkv6":
        for nm in ("x", "w", "k", "v", "r", "g"):
            vec(t + f"lerp_{nm}.weight", 1, 1, E_, base=0.5, s=0.2)
        mat(t + "w1.weight", 5 * c["MIX"], E_)
        mat(t + "w2.weight", 5, E_, c["MIX"])
        vec(t + "first.weight", H_, HS, s=0.5)
        vec(t + "decay.weight", E_, base=-4.0, s=0.5)
        mat(t + "decay_w1.weight", c["DEC"], E_)
        mat(t + "decay_w2.weight", E_, c["DEC"])
        mat(t + "gate.weight", E_, E_)
        mat(p + "channel_mix_receptance.weight", E_, E_)
        vec(p + "channel_mix_lerp_r.weight", 1, 1, E_, base=0.5, s=0.2)
    else:
        for nm in ("r", "w", "k", "v", "a", "g"):
            vec(t + f"lerp_{nm}.weight", 1, 1, E_, base=0.5, s=0.2)
        vec(t + "w0.weight", E_, base=-4.0, s=0.5)
        mat(t + "w1.weight", c["W"], E_)
        mat(t + "w2.weight", E_, c["W"])
        vec(t + "a0.weight", E_, s=0.3)
        mat(t + "a1.weight", c["A"], E_)
        mat(t + "a2.weight", E_, c["A"])
        if i > 0:                          # layer 0 sets v_first
            vec(t + "v0.weight", E_, s=0.3)
            mat(t + "v1.weight", c["VR"], E_)
            mat(t + "v2.weight", E_, c["VR"])
        mat(t + "g1.weight", c["G"], E_)
        mat(t + "g2.weight", E_, c["G"])
        vec(t + "k_k.weight", E_, base=0.8, s=0.3)
        vec(t + "k_a.weight", E_, base=0.8, s=0.3)
        vec(t + "r_k.weight", H_, HS, s=0.3)
    for nm in ("receptance", "key", "value", "output"):
        mat(t + f"{nm}.weight", E_, E_)
    vec(t + "ln.weight", E_, base=1.0)
    vec(t + "ln.bias", E_)
    vec(p + "channel_mix_lerp_k.weight", 1, 1, E_, base=0.5, s=0.2)
    mat(p + "channel_mix_key.weight", FF_, E_)
    mat(p + "channel_mix_value.weight", E_, FF_)


def _qwen3next_layer(c, p, i, mat, vec, rng, w):
    """One qwen3-next layer (tests/test_mamba.py's qwen3next export):
    gated attention every 4th layer (attn_q and its gate attn_gate, q/k
    norms), else the gated DeltaNet; then the experts and the gated shared
    expert."""
    E_ = c["E"]
    vec(p + "ffn_norm.weight", E_, base=1.0)
    if (i + 1) % 4 == 0:
        H_, HKV_, D_ = c["H"], c["HKV"], c["D"]
        mat(p + "attn_q.weight", H_ * D_, E_)
        mat(p + "attn_gate.weight", H_ * D_, E_)
        mat(p + "attn_k.weight", HKV_ * D_, E_)
        mat(p + "attn_v.weight", HKV_ * D_, E_)
        mat(p + "attn_output.weight", E_, H_ * D_)
        vec(p + "attn_q_norm.weight", D_, base=1.0)
        vec(p + "attn_k_norm.weight", D_, base=1.0)
    else:
        hk, hv, dk, dv, dc = c["HK"], c["HV"], c["DK"], c["DV"], c["DC"]
        R = hv // hk
        conv_dim = 2 * hk * dk + hv * dv
        mat(p + "ssm_in.weight", hk * (2 * dk + 2 * R * dv), E_)
        mat(p + "ssm_beta_alpha.weight", hk * 2 * R, E_)
        vec(p + "ssm_conv1d.weight", conv_dim, dc, s=0.3)
        vec(p + "ssm_dt.bias", hv, base=0.5, s=0.1)
        w.add_tensor(p + "ssm_a.weight", -(1.0 + rng.uniform(
            0.0, 3.0, hv)).astype(np.float32))
        vec(p + "ssm_norm.weight", dv, base=1.0)
        mat(p + "ssm_out.weight", E_, hv * dv)
    X_, FE = c["X"], c["FFE"]
    w.add_tensor(p + "ffn_gate_inp.weight", rng.standard_normal(
        (X_, E_), dtype=np.float32) * 0.02)
    mat(p + "ffn_gate_exps.weight", X_, FE, E_)
    mat(p + "ffn_up_exps.weight", X_, FE, E_)
    mat(p + "ffn_down_exps.weight", X_, E_, FE)
    mat(p + "ffn_gate_shexp.weight", c["SH"], E_)
    mat(p + "ffn_up_shexp.weight", c["SH"], E_)
    mat(p + "ffn_down_shexp.weight", E_, c["SH"])
    w.add_tensor(p + "ffn_gate_inp_shexp.weight", rng.standard_normal(
        (1, E_), dtype=np.float32) * 0.02)


def rec_small_forward(params, cfg, device, kv_dtype):
    """small_forward on the recurrent forward: two prefill chunks of 16
    rows a slot (2 slots; the second slot 11 then 7 rows), then one decode
    step, at full width (a 64-position KV for a hybrid's attention
    layers). Returns the logits [6, V] f32 on the CPU."""
    from llama_box_tpu_torch.models import llama, mamba
    S, T, C = 2, 16, 64
    rng = np.random.default_rng(5)
    toks = rng.integers(3, cfg.vocab_size, (3, S, T)).astype(np.int64)
    cache = mamba.init_rec_cache(cfg, S, capacity=C, params=params,
                                 dtype=kv_dtype, device=device)
    cos = sin = None
    if cfg.n_heads > 0:
        cos, sin = llama.make_rope(cfg, C, device=device)
    out = []
    for i, (p, n) in enumerate(((np.zeros(S, np.int64), np.array([T, 11])),
                                (np.array([T, 11]), np.array([T, 7])))):
        lg, _ = mamba.rec_prefill_batch_impl(
            params, cfg, torch.from_numpy(toks[i]), p, n, cache, cos, sin)
        out.append(lg.float().cpu())
    dev = torch.device(device)
    lg = mamba._decode_step(params, cfg, torch.from_numpy(toks[2, :, 0]).to(
        dev), torch.tensor([2 * T, 18], device=dev),
        torch.tensor([True, True], device=dev), cache, cos, sin)
    out.append(lg.float().cpu())
    return torch.cat(out)


def rec_reference(path: str, name: str, seed: int):
    """A worker's job beside phases 3 and 4: write the file, then its f32
    forward on the host (the plain versions): (path, logits)."""
    from llama_box_tpu_torch.models.loader import load_model
    torch.set_num_threads(2)
    write_rec_variant(path, name, seed)
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    return path, rec_small_forward(params, cfg, "cpu", torch.float32)


def _rec_turns(engine, routes, counters, ref=None) -> dict:
    """phase 17's extra checks, on the served engine: a turn that extends
    the first one's prompt and answer exactly reuses the slot's state
    (n_cached), and gives a cold engine's tokens up to the first near tie;
    TTFT p50 of a wave of 4 chats."""
    from llama_box_tpu_torch.sampling import SamplerParams
    from llama_box_tpu_torch.server.engine import Engine
    from llama_box_tpu_torch.server.task import CompletionsTask
    from llama_box_tpu_torch.ops.qmatmul import QTensor
    tok = engine.tokenizer
    rng = np.random.default_rng(7)
    out = {}
    if any(isinstance(w, QTensor) for gp in (engine.params.get(
            "layer_groups") or [engine.params["layers"]])
            for w in gp.values()):
        # the w8a8 path against its plain versions on the host
        got = rec_small_forward(engine.params, engine.cfg, engine.device,
                                torch.bfloat16)
        want = rec_small_forward(_moved(engine.params, "cpu"), engine.cfg,
                                 "cpu", torch.bfloat16)
        out["cosine_plain"] = _cosine(got, want)
        out["cosine_plain_f32"] = _cosine(want, ref)
        log(f"    rec_small_forward's logits, card vs the plain versions on "
            f"the host over the same QTensors: cosine "
            f"{out['cosine_plain']:.6f} (tol {REC_PLAIN_COS}); the plain "
            f"versions vs f32 {out['cosine_plain_f32']:.6f}")
        assert out["cosine_plain"] >= REC_PLAIN_COS, out
    p1 = [1] + rng.integers(300, 20000, 150).tolist()

    def one(eng, prompt, n):
        t = CompletionsTask(list(prompt), SamplerParams(temp=0.0,
                                                        ignore_eos=True),
                            tokenizer=tok, max_tokens=n, n_probs=2)
        eng.submit(t)
        wait_final(t)
        return t
    f1 = one(engine, p1, REC_TURN_TOKENS)
    p2 = p1 + list(f1.generated) + rng.integers(300, 20000, 40).tolist()
    f2 = one(engine, p2, 24)
    reused = f2.n_cached == len(p1) + len(f1.generated) - 1
    cold_eng = Engine(engine.cfg, engine.params, tok, dataclasses.replace(
        engine.ecfg, cuda_graphs=False, pipeline_chain=False),
        device=str(engine.device))
    cold_eng.start()
    try:
        fc = one(cold_eng, p2, 24)
    finally:
        cold_eng.stop()
    def margin(pr):
        p0, p1 = pr.top_probs[:2]
        return float(np.log(p0) - np.log(max(p1, 1e-30)))
    pairs = [[(t, margin(pr)) for t, pr in zip(x.generated, x.probs)]
             for x in (f2, fc)]
    (j, same, part, _), = same_to_near_tie([pairs[0]], [pairs[1]])
    # TTFT p50 of 4 concurrent requests of about VARIANT_PROMPT tokens
    tasks = [CompletionsTask(
        [1] + rng.integers(300, 20000, VARIANT_PROMPT).tolist(),
        SamplerParams(temp=0.0), tokenizer=tok, max_tokens=16)
        for _ in range(N_SLOTS)]
    for t in tasks:
        engine.submit(t)
    for t in tasks:
        wait_final(t)
    ttft = [t.timings()["time_to_first_token_ms"] for t in tasks]
    out.update(turn2_cached=f2.n_cached, turn2_reused=reused,
               turn2_equal_cold=same, turn2_parts_at=part,
               turn2_first_near_tie=j, ttft_p50_ms=statistics.median(ttft))
    log(f"    second turn: {f2.n_cached} of {len(p2)} prompt tokens reused "
        f"(exact extension: {reused}); the same tokens as a cold engine up "
        f"to the first near tie (token {j} of {len(f2.generated)}); whole "
        f"texts equal: {same} (parting at {part}); TTFT p50 "
        f"{out['ttft_p50_ms']:.2f} ms")
    assert reused, "the exact extension did not reuse the state"
    return out


def rec_phase(dev, seed, tmp, refs, names) -> dict:
    """Phase 17 (see the module docstring): each model of `names` on its
    REC_MODES paths through variant_serve, with rec_small_forward against
    the worker's f32 host forward and _rec_turns."""
    log("== phase 17: the recurrent families at published widths: "
        + ", ".join(names))
    t_phase = time.perf_counter()
    out = {}
    for name in names:
        path, ref = refs[name]
        out[name] = {mode: variant_serve(
            dev, seed, tmp, name, path, mode, ref, paths=REC_PATHS,
            forward=rec_small_forward,
            extra=lambda e, r, c, ref=ref: _rec_turns(e, r, c, ref),
            cos_min=REC_COS[mode])
            for mode in REC_MODES.get(name, ("bf16",))}
        os.remove(path)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 17: {out['seconds']:.1f} s")
    return out


def rec_family_phase(dev, seed, tmp) -> dict:
    """--families' recurrent models: granite-4.0-h-micro's first 6 layers,
    RWKV-6-1.6B and Qwen3-Next's first 4 layers served on bf16 as phase
    17's; Jamba2-3B's 20 query heads over
    one KV head exceed the flash decode kernel's group of 16, so the CLI
    must refuse it at load by that cause (its mixers' scan runs at its
    widths in phase 3r)."""
    from llama_box_tpu_torch import cli
    log("== families (recurrent): " + ", ".join(REC_FAMILY_VARIANTS))
    out = {}
    for name in REC_FAMILY_VARIANTS:
        path = f"{tmp}/synthetic-{name}-q8_0.gguf"
        t0 = time.perf_counter()
        _, ref = rec_reference(path, name, seed)
        log(f"  {name}: written and its f32 forward on the host in "
            f"{time.perf_counter() - t0:.1f} s")
        if name == "jamba2-3b":
            try:
                cli.build_server(["-m", path, "--port", "0", "-np",
                                  str(N_SLOTS), "-c", "4096", "--no-jinja",
                                  "--device", dev.type])
            except NotImplementedError as exc:
                out[name] = {"refused": str(exc)}
                log(f"  {name}: refused at load: {exc}")
                assert "query heads per KV head" in str(exc)
            else:
                raise AssertionError(f"{name}: served past the kernels' "
                                     "group limit")
        else:
            out[name] = {"bf16": variant_serve(
                dev, seed, tmp, name, path, "bf16", ref, paths=REC_PATHS,
                forward=rec_small_forward,
                extra=lambda e, r, c, ref=ref: _rec_turns(e, r, c, ref))}
        os.remove(path)
    return out


# phases 11 to 14's files and f32 host forwards (file_reference), made by
# LATE_WORKERS processes of LATE_THREADS torch threads each from phase 6
# on, the longest first: beside the host's share of phases 6 to 16
LATE_WORKERS, LATE_THREADS = 3, 2


def late_jobs(pool, tmp, seed) -> dict:
    """Submit phases 11 to 14's file_reference jobs to `pool`: name ->
    Future."""
    jobs = [(MOE_NAME, "small")] + [(n, "small") for n in MLA_VARIANTS] \
        + [(n, "small") for n in VARIANTS] \
        + [(n, "long") for n in ATTN_VARIANTS]
    return {n: pool.submit(file_reference, f"{tmp}/synthetic-{n}-q8_0.gguf",
                           n, seed, fwd) for n, fwd in jobs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace 4 greedy requests with torch.profiler, "
                    "graphs on and off")
    ap.add_argument("--families", action="store_true",
                    help="also serve jetmoe's, openelm's, granite-4.0-h-"
                    "micro's, RWKV-6's and Qwen3-Next's published widths "
                    "(FAMILY_VARIANTS, REC_FAMILY_VARIANTS) and check "
                    "Jamba2-3B's refusal")
    ap.add_argument("--depth-check", type=int, default=0, metavar="LAYERS",
                    help="also hold Qwen3-1.7B's w8a8 path at LAYERS layers "
                    "against the plain versions and f32, layer by layer")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card (torch.cuda.is_available() "
                         "is false)")
    from llama_box_tpu_torch.ops import _kernels

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log("== phase 1: device")
    log(f"  nvidia-smi: {card}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("== phase 2: build (nvcc -Xptxas -v)")
    t0 = time.perf_counter()
    paths = _kernels.build()
    log(f"  built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, report in sorted(_kernels.ptxas_report.items()):
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                log(f"  [{name}] {line.strip()}")
    names = ("flash_prefill_mma_kernel", "flash_decode_mma_kernel",
             "grouped_gemm_kernel", "norm_qmm_kernel", "tail_phase_kernel",
             "w8a8_gemm", "quant_rows_kernel", "11norm_kernel",
             "align_kernel", "gate_up_kernel", "down_kernel",
             "combine_kernel", "ssm_scan_kernel", "wkv_kernel")
    for entry, used, spill in ptxas_entries(
            "\n".join(_kernels.ptxas_report.values()), names):
        short = entry[min(entry.find(n) for n in names if n in entry):]
        log(f"  kernel {short[:80]}: {used}; {spill}")

    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmp_dir.name
    spawn = multiprocessing.get_context("spawn")
    # phase 5's three GGUFs, phase 15's pairs and phase 17's files with
    # their f32 host forwards are made by worker processes (numpy and
    # torch on the host) while the kernel phases run on the card; all are
    # done before the first served request, so no wave of phase 5 shares
    # the host. Phases 11 to 14's files and host forwards are made by
    # LATE_WORKERS more from phase 6 on (late_jobs): they share the host
    # with phases 6 to 16, which time the card's work and the server's
    # waves but gate nothing on a rate
    with ProcessPoolExecutor(len(MODEL_TYPES) + len(MM_VARIANTS)
                             + len(REC_DEFAULT), mp_context=spawn) as pool:
        t_w = time.perf_counter()
        writes = {fmt: pool.submit(write_model, _model_path(tmp, fmt),
                                   args.seed, fmt) for fmt in MODEL_TYPES}
        for n in MM_VARIANTS:
            writes[n] = pool.submit(write_mm_pair, tmp, n, args.seed)
        # phase 17's files and their f32 host forwards
        for n in REC_DEFAULT:
            writes[n] = pool.submit(rec_reference,
                                    f"{tmp}/synthetic-{n}-q8_0.gguf", n,
                                    args.seed)
        errs, rows = kernel_phase(dev, args.seed)
        w_errs, w_rows = w8a8_kernel_phase(dev, args.seed)
        q_errs, q_rows = q_kernel_phase(dev, args.seed)
        n_errs, n_rows = norm_kernel_phase(dev, args.seed)
        m_errs, m_rows = moe_kernel_phase(dev, args.seed)
        r_errs, r_rows = rec_kernel_phase(dev, args.seed)
        for w in writes.values():
            w.result()
        mm_pairs = {n: writes[n].result() for n in MM_VARIANTS}
        rec_refs = {n: writes[n].result() for n in REC_DEFAULT}
        log(f"  phase 5's, 15's and 17's GGUFs written beside the "
            f"kernel phases: {time.perf_counter() - t_w:.1f} s from their "
            f"start")
    errs.update(w_errs)
    errs.update(q_errs)
    errs.update(n_errs)
    errs.update(m_errs)
    errs.update(r_errs)
    launches, e2e = {}, {}
    capture_failure_check()
    late = ProcessPoolExecutor(LATE_WORKERS, mp_context=spawn,
                               initializer=torch.set_num_threads,
                               initargs=(LATE_THREADS,))
    ok = False
    try:
        with tmp_dir:
            for mode in PATHS:
                launches[mode], e2e[mode], served = e2e_phase(
                    dev, args.seed, tmp, args.profile, mode)
                if mode == "bf16":
                    bf16_served = served
                del served
            refs = late_jobs(late, tmp, args.seed)
            e2e["kv_edit"] = kv_edit_phase(dev, args.seed, *bf16_served)
            e2e["spec"] = spec_phase(dev, args.seed, tmp,
                                     _model_path(tmp, "f16"), *bf16_served)
            e2e["embed"] = embed_phase(dev, args.seed, tmp, *bf16_served)
            del bf16_served
            e2e["lora"] = lora_phase(dev, args.seed, tmp)
            e2e["variants"] = variant_phase(dev, args.seed, tmp, refs)
            e2e["attn_variants"] = attn_variant_phase(dev, args.seed, tmp,
                                                      refs)
            e2e["moe"] = moe_phase(dev, args.seed, tmp, refs)
            e2e["mla"] = mla_phase(dev, args.seed, tmp, refs)
            e2e["mm"] = mm_phase(dev, args.seed, mm_pairs)
            e2e["rec"] = rec_phase(dev, args.seed, tmp, rec_refs,
                                   REC_DEFAULT)
            if args.families:
                e2e["families"] = family_phase(dev, args.seed, tmp)
                e2e["families"].update(rec_family_phase(dev, args.seed,
                                                        tmp))
            if args.depth_check:
                e2e["depth"] = depth_check(dev, args.seed, tmp,
                                           "qwen3-1.7b", args.depth_check)
        ok = True
    finally:
        if not ok:      # the workers' jobs end with the run
            for proc in list((late._processes or {}).values()):
                proc.terminate()
        late.shutdown(wait=True, cancel_futures=not ok)

    pick = {"flash_prefill": ("prefill", "bf16", 0),
            "flash_decode": ("decode", "bf16", 1023),
            "w8a8_matmul": [2048, E, 2 * FF],
            "fused_norm_qmm": [4, E, V],
            "fused_layer_tail": [4, H * D, E, FF],
            "q4_matmul": [4, E, 2 * FF],
            "q8_matmul": [4, E, V],
            "row_norm": NORM_TIMED[0]}
    shapes = {"flash_prefill": "q[4,4,8,512,64] bf16, C=2048, pos0=0",
              "flash_decode": "q[4,4,8,64] bf16, C=2048, cpos=1023, R=16",
              "w8a8_matmul": "x[2048,2048] bf16 . qs[2048,11264] (gate|up)",
              "fused_norm_qmm": "x[4,2048] bf16 . qs[2048,32000] (output)",
              "fused_layer_tail": "R=4, HD=E=2048, FF=5632, silu",
              "q4_matmul": "x[4,2048] bf16 . Q4_K packed qs[1024,11264] "
                           "(gate|up), bf16 out",
              "q8_matmul": "x[4,2048] bf16 . Q6_K codes qs[2048,32000] "
                           "(output), bf16 out",
              "row_norm": "rms x[4,2048] bf16, weight [2048] bf16"}
    srcs = {"flash_prefill": ("llama_box_tpu_torch/csrc/flash_prefill.cu",
                              "llama_box_tpu/ops/flash_prefill.py:75"),
            "flash_decode": ("llama_box_tpu_torch/csrc/flash_decode.cu",
                             "llama_box_tpu/ops/flash_decode.py:76"),
            "w8a8_matmul": ("llama_box_tpu_torch/csrc/w8a8_matmul.cu",
                            "scripts/probe_qmm_pallas.py:28"),
            "fused_norm_qmm": ("llama_box_tpu_torch/csrc/fused_norm_qmm.cu",
                               "llama_box_tpu/ops/fused_decode.py:67"),
            "fused_layer_tail": (
                "llama_box_tpu_torch/csrc/fused_layer_tail.cu",
                "llama_box_tpu/ops/fused_decode.py:115"),
            "q4_matmul": ("llama_box_tpu_torch/csrc/q_matmul.cu",
                          "llama_box_tpu/ops/qmatmul.py:202"),
            "q8_matmul": ("llama_box_tpu_torch/csrc/q_matmul.cu",
                          "llama_box_tpu/ops/qmatmul.py:237"),
            # no Pallas kernel: the JAX norms are XLA (ops/norm.py:9,
            # models/llama.py:503, :442); added for one order a row
            "row_norm": ("llama_box_tpu_torch/csrc/norm.cu",
                         "none (port-only; XLA in llama_box_tpu/ops/"
                         "norm.py:9)")}
    # the path whose main-path run counts each kernel's launches
    home = {"flash_prefill": "bf16", "flash_decode": "bf16",
            "w8a8_matmul": "w8a8", "fused_norm_qmm": "w8a8",
            "fused_layer_tail": "w8a8", "q4_matmul": "q4", "q8_matmul": "q4",
            "row_norm": "bf16"}
    # each path's self-drafting wave (phase 8, 8w, 8q)
    spec_launches = {m: (e2e["spec"]["waves"]["self_graphs"] if m == "bf16"
                         else e2e[m]["spec"]["waves"]["self"])["launches"]
                     for m in PATHS}
    # each path's embeddings request (phase 10, 10w, 10q); bf16's window
    # also holds the chats' decode chains
    embed_launches = {m: (e2e["embed"]["llama"] if m == "bf16"
                          else e2e[m]["embed"])["launches"] for m in PATHS}
    kernels = []
    for name in srcs:
        if name.startswith("flash"):
            r = next(x for x in rows if (x["kind"], x["cache"], x["pos"])
                     == pick[name])
        elif name == "row_norm":
            r = next(x for x in n_rows if x["case"] == pick[name])
        else:
            # the grouped kernels: the bf16 output the server asks for
            r = next(x for x in w_rows + q_rows if x["kind"] == name
                     and x["shape"] == pick[name]
                     and x.get("out", "bfloat16") == "bfloat16")
        kernels.append(dict(
            name=name, route="cuda", source=srcs[name][0],
            replaces=srcs[name][1], launches=launches[home[name]][name],
            max_abs_err=errs[name], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=shapes[name],
            launches_by_path={m: launches[m][name] for m in PATHS},
            launches_self_draft={m: spec_launches[m][name] for m in PATHS},
            launches_spec_bf16={
                k: e2e["spec"]["waves"][k + "_graphs"]["launches"][name]
                for k in ("ngram", "self", "draft2")},
            launches_embed={m: embed_launches[m][name] for m in PATHS},
            launches_variants={
                f"{v} {m}": e2e[ph][v][m]["launches_one_request"][name]
                for ph, vs in (("variants", VARIANTS),
                               ("attn_variants", ATTN_VARIANTS),
                               ("moe", MOE_VARIANTS),
                               ("mla", MLA_VARIANTS))
                for v in vs for m in VARIANT_PATHS},
            launches_multimodal={
                f"{v} {m}": e2e["mm"][v][m]["launches_one_request"][name]
                for v in MM_VARIANTS for m in MM_PATHS[v]},
            launches_lora={m: e2e["lora"][m]["launches_one_request"][name]
                           for m in PATHS},
            launches_cvec={m: e2e["lora"]["cvec"][m]
                           ["launches_one_request"][name]
                           for m in ("bf16", "w8a8")},
            **({} if not name.startswith("flash") else {"variant_shapes": [
                dict(case=x["cache"], q=x["q"], C=x["C"], pos=x["pos"],
                     dv=x["dv"], ms=x["ms"], plain_ms=x["plain_ms"],
                     bound_ms=x["bound_ms"], bound_by=x["bound_by"],
                     library_ms=x["library_ms"],
                     **({"sdpa_backend": x["sdpa_backend"]}
                        if "sdpa_backend" in x else {}))
                for x in rows if x["kind"] == name[6:]
                and (x["cache"] in ATTN_KERNEL_CASES
                     or x["cache"].split(" ")[0] in MLA_KERNEL_CASES)]})))
    # the routed-expert kernel (port-only): its main path is phase 13's
    # bf16 path, one request counted from 0
    moe = e2e["moe"][MOE_NAME]
    r = next(x for x in m_rows if x["case"] == MOE_MAIN)
    kernels.append(dict(
        name="moe_ffn", route="cuda",
        source="llama_box_tpu_torch/csrc/moe_ffn.cu",
        replaces="none (port-only; XLA in llama_box_tpu/models/llama.py:"
                 "1073, _moe_mix)",
        launches=moe["bf16"]["launches_one_request"]["moe_ffn"],
        max_abs_err=errs["moe_ffn"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"], shape=MOE_MAIN,
        launches_by_path={m: moe[m]["launches_one_request"]["moe_ffn"]
                          for m in MOE_PATHS},
        launches_self_draft=moe["bf16"]["self_draft"]["launches"]["moe_ffn"],
        launches_mla={
            f"{v} {m}": e2e["mla"][v][m]["launches_one_request"]["moe_ffn"]
            for v in MLA_VARIANTS for m in MLA_PATHS},
        timed_shapes=[{k: x[k] for k in ("case", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")} for x in m_rows]))
    # the recurrent kernels (port-only): their main path is phase 17, one
    # request counted from 0 (Mamba-1.4B's bf16 path, RWKV-7's)
    rec = e2e["rec"]
    rec_home = {"ssm_scan": "mamba-1.4b", "wkv": "rwkv7-1.5b"}
    rec_replaces = {
        "ssm_scan": "none (port-only; XLA: the associative scans of "
                    "llama_box_tpu/models/mamba.py:217 and :295)",
        "wkv": "none (port-only; XLA: llama_box_tpu/models/mamba.py:392 "
               "and the scans of llama_box_tpu/models/rwkv.py:106, :248, "
               ":344)"}
    for name in ("ssm_scan", "wkv"):
        r = next(x for x in r_rows if x["case"] == REC_MAIN[name])
        kernels.append(dict(
            name=name, route="cuda",
            source=f"llama_box_tpu_torch/csrc/{name}.cu",
            replaces=rec_replaces[name],
            launches=rec[rec_home[name]]["bf16"]["launches_one_request"][
                name],
            max_abs_err=errs[name], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            library="no PyTorch call", shape=REC_MAIN[name],
            launches_by_model={
                f"{v} {m}": rec[v][m]["launches_one_request"][name]
                for v in REC_DEFAULT for m in rec[v]},
            timed_shapes=[{k: x[k] for k in ("case", "ms", "plain_ms",
                                            "bound_ms", "bound_by")}
                          for x in r_rows if x["kind"] == name]))
    e2e.update(card=card, seconds=time.perf_counter() - t_start)
    if args.profile:
        for label in MODES:
            log(f"  decode profile busy share ({label}): " + "   ".join(
                f"{m} {e2e[m]['profile'][label]['busy_share']:.3f}"
                for m in PATHS))
    for k in ("ttft_p50_ms", "prefill_tok_s", "decode_tok_s",
              "window_tok_s", "arrival_ttft_p50_ms", "arrival_bg_tok_s"):
        if k in e2e[next(iter(PATHS))]:
            log(f"  {k:<19s} " + "   ".join(f"{m} {e2e[m][k]:10.2f}"
                                             for m in PATHS))
        for label in MODES:
            log(f"  {k:<19s} " + "   ".join(
                f"{m} {e2e[m]['modes'][label][k]:10.2f}" for m in PATHS)
                + f"   ({label}, phase c)")
    for tag, r in e2e["kv_edit"].items():
        sh, cp = r["shift"], r["copy"]
        log(f"  phase 6, {tag} cache: shift {sh['shift_ms']:.5f} ms (bound "
            f"{sh['shift_bound_ms']:.5f}); copy of {SHARE_PREFIX} rows "
            f"{cp['copy_ms']:.5f} ms (bound {cp['copy_bound_ms']:.5f}); "
            f"shared-prefix TTFT p50 {cp['copy']['ttft_p50_ms']:.2f} ms by "
            f"copy, {cp['recompute']['ttft_p50_ms']:.2f} ms recomputed")
    for m in PATHS:
        h = e2e[m]["host"]["graphs"]
        sm = h["sampler_ms"]
        log(f"  phase 7, {m}: one-token pass device ms p50 "
            f"{h['pass_dev_ms_p50']:.5f} p90 {h['pass_dev_ms_p90']:.5f}, "
            f"host ms p50 {h['pass_host_ms_p50']:.3f} p90 "
            f"{h['pass_host_ms_p90']:.3f} (a wave pass, wall - its replay's "
            f"device ms); host sampler ms a token grammar p50 "
            f"{sm['grammar']['p50']:.3f} p90 {sm['grammar']['p90']:.3f}, "
            f"mirostat p50 {sm['mirostat']['p50']:.3f} p90 "
            f"{sm['mirostat']['p90']:.3f}; constrained tok/s "
            + " ".join(f"{k} {v:.1f}" for k, v in
                       h["constrained_tok_s"].items())
            + f"; plain greedy tok/s beside {h['plain_beside_tok_s']:.1f}, "
            f"alone {h['plain_alone_tok_s']:.1f}; rate-limited "
            f"{h['rate_tok_s']:.2f} tok/s (header {RATE_TPS})")
    sp = e2e["spec"]
    log("  phase 8, bf16: decode tok/s (acceptance) " + ", ".join(
        f"{k} {w['decode_tok_s']:.1f}"
        + (f" ({w['acceptance']:.3f})" if w["acceptance"] is not None
           else "") for k, w in sp["waves"].items()))
    log(f"  phase 8, bf16: verify pass (T {1 + SPEC_DRAFT}) "
        f"{sp['verify_costs']['verify_ms']:.5f} ms, one-row pass "
        f"{sp['verify_costs']['one_ms']:.5f} ms, 16-step chain "
        f"{sp['verify_costs']['chain16_ms']:.5f} ms device; pool MiB plain "
        f"{sp['waves']['plain16']['graph_pool_mib']:.1f}, self-draft "
        f"{sp['waves']['self_graphs']['graph_pool_mib']:.1f}, 2-layer draft "
        f"{sp['waves']['draft2_graphs']['graph_pool_mib']:.1f}")
    for m in PATHS:
        bits = (sp if m == "bf16" else e2e[m]["spec"])["bits"]
        log(f"  phase 8, {m}: verify rows = one-row steps bit for bit: "
            + ", ".join(f"{k} cache logits {v['logits_equal']} (max diff "
                        f"{v['max_abs_diff']:.3e}) kv {v['kv_equal']}"
                        + (f", first parting op {v['first_parting_op']}"
                           if "first_parting_op" in v else "")
                        for k, v in bits.items()))
    em = e2e["embed"]
    log(f"  phase 10: /v1/embeddings bge-base width {em['bert']['tok_s']:.1f} "
        f"tok/s, TinyLlama beside 3 chats {em['llama']['tok_s']:.1f} tok/s; "
        f"/v1/rerank {em['rerank']['docs_s']:.1f} docs/s; one ('embed', "
        f"{EMBED_KEY_ROWS}, {EMBED_KEY_T}) replay: bge-base "
        f"{em['bert']['replay']['ms']:.4f} ms (bound "
        f"{em['bert']['replay']['bound_ms']:.4f}), TinyLlama "
        f"{em['llama']['replay']['ms']:.4f} ms (bound "
        f"{em['llama']['replay']['bound_ms']:.4f})")
    for ph, key in ((11, "variants"), (12, "attn_variants"), (13, "moe"),
                    (14, "mla")):
        for name, r in e2e[key].items():
            if name in ("seconds", "layers"):
                continue
            for mode, x in r.items():
                log(f"  phase {ph}, {name} {mode}: load s "
                    f"{x['load_s']:.1f}, decode tok/s "
                    f"{x['decode_tok_s']:.1f}, window tok/s "
                    f"{x['window_tok_s']:.1f}, cosine {x['cosine']:.6f}, "
                    f"{x['norm_launches_a_step']} row_norm launches a "
                    f"step, kernels a layer {x['ops_a_layer']:.2f} (plain "
                    f"norms {x['ops_a_layer_plain_norms']:.2f})")
    for name in MM_VARIANTS:
        for mode, x in e2e["mm"][name].items():
            tw = e2e["mm"][name]["bf16"]
            log(f"  phase 15, {name} {mode}: load s {x['load_s']:.1f}, tower "
                f"ms {tw['tower_ms']}, embedding cosine {tw['emb_cos']}, "
                f"logits cosine {x['logits_cos']:.6f}, decode gap err "
                f"{x.get('decode_gap_err')}, captures in the measured wave "
                f"{x['captured_in_wave']}, pool MiB {x['pool_mib']:.1f}, "
                f"prefill tok/s "
                f"{x['prefill_tok_s']:.1f}, decode tok/s "
                f"{x['decode_tok_s']:.1f}, flash_prefill / flash_decode "
                f"launches of one media request "
                f"{x['launches_one_request']['flash_prefill']} / "
                f"{x['launches_one_request']['flash_decode']}")
    lo = e2e["lora"]
    for m in PATHS:
        x = lo[m]
        log(f"  phase 16, {m}: LoRA vs base decode tok/s "
            f"{x['lora']['decode_tok_s']:.1f} / "
            f"{x['base']['decode_tok_s']:.1f}, TTFT p50 ms {x['lora']['ttft_p50_ms']:.2f} / "
            f"{x['base']['ttft_p50_ms']:.2f}, kernels a layer a decode step "
            f"{x['kernels_a_layer']:.2f} / {x['base_kernels_a_layer']:.2f}; "
            f"captures in the mixed wave {x['captured_mixed']}, without "
            f"fields {x['captured_no_fields']}; graphs LoRA "
            f"{x['graphs_after']} / base {x['base_graphs_after']}; "
            f"{x['drafted']} n-gram drafts")
    log(f"  phase 16b/c: cosines {json.dumps(lo['static'])}; control vector "
        + "; ".join(f"{m} {lo['cvec'][m]['cos_host']:.6f}"
                    for m in lo["cvec"]))
    for name in REC_DEFAULT:
        for mode, x in e2e["rec"][name].items():
            log(f"  phase 17, {name} {mode}: load s {x['load_s']:.1f}, "
                f"decode tok/s {x['decode_tok_s']:.1f}, window tok/s "
                f"{x['window_tok_s']:.1f}, TTFT p50 ms "
                f"{x['ttft_p50_ms']:.2f}, cosine {x['cosine']:.6f}, second "
                f"turn reused {x['turn2_cached']} tokens, = cold "
                f"{x['turn2_equal_cold']} (parting at {x['turn2_parts_at']}, "
                f"first near tie {x['turn2_first_near_tie']}), launches of "
                f"one request "
                + json.dumps({k: n for k, n in
                              x["launches_one_request"].items() if n}))
    log("e2e " + json.dumps(e2e))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
