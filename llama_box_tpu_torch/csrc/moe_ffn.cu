// The routed experts of a mixture-of-experts FFN: for each row n of h and
// each of its K picks k (expert topi[n,k], weight topv[n,k]),
//   pair(n,k) = down_x(act(h[n] . gate_x (+ b_gate_x), h[n] . up_x (+ b_up_x)))
//               (+ b_down_x)
//   y[n] = scale * sum over k, in ascending expert index, of topv[n,k] * pair(n,k)
// or, with weight_before (llama4), the gate and up products scaled by
// topv[n,k] and the pairs summed unweighted.
//
// Replaces no Pallas kernel: the JAX package's `_moe_mix`
// (llama_box_tpu/models/llama.py) computes every expert densely in f32 under
// a 0/weight routing mask, which XLA on a TPU streams whole. On this card
// that reads all X experts and does X / K times the work; here only the
// routed experts' rows are computed, on the tensor cores.
//
// What bounds it: at decode (a few rows) the bytes of the distinct experts
// the rows pick; at prefill widths (thousands of rows, every expert picked)
// the operations, 6 x N x K x E x F. Each expert's weights are read once a
// tile of BM = 64 rows: fewer re-reads than a smaller tile at prefill, a
// padded tile at decode costs tensor-core work, which is not the bound.
//
// Four kernels, grids and buffers fixed by N, K and X alone (the engine
// replays them in CUDA graphs); blocks past the live tiles exit.
//  1. align: one block an expert counting-sorts the N K pairs by expert
//     into segments padded to BM (pair ids in row order within an expert,
//     -1 padding), with each tile's expert and the live tile count.
//  2. gate_up: a tile's BM gathered rows times a BN-column slice of its
//     expert's gate and up ([E, F] each), mma.sync m16n8k16 bf16 with f32
//     accumulation over E in BK steps (cp.async, two stages); the epilogue
//     applies the weight (weight_before), the biases and the activation in
//     f32 and stores act as two bf16 parts, hi = bf16(act) and lo =
//     bf16(act - hi) (JAX keeps act in f32; the pair carries about 16 bits
//     of its mantissa).
//  3. down: a tile's act rows (hi and lo) times a BN-column slice of the
//     expert's down [F, E], the same core, hi then lo at every step; adds
//     b_down and writes each valid pair's [E] f32 row.
//  4. combine: one block a row sums its K pairs in ascending expert index
//     (each term rounded once by the weight's product, then added), times
//     scale.
// Row independence: every output element accumulates over its reduction
// dimension in one order fixed by E, F and the tile shape; a row's tile
// partners change only other rows of the products; no split of a
// reduction depends on N, and no sum uses atomics (align's histogram
// counts integers). So a row's bits do not depend on which rows share
// the call.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;   // pair rows a tile (4 warps x 16)
constexpr int BN = 64;   // output columns a block (8 n8 fragments a warp)
constexpr int BK = 32;   // reduction a stage (2 k16 steps)
constexpr int kThreads = 128;
constexpr int LDA = BK + 8;   // shared row pitches (elements): 80 / 144
constexpr int LDB = BN + 8;   // bytes, 16-byte aligned, ldmatrix rows in
                              // distinct bank groups
constexpr int kAlignThreads = 256;
constexpr int kCombineThreads = 256;
constexpr int kMaxPicks = 64;

enum Act { ACT_SILU = 0, ACT_GELU = 1, ACT_RELU2 = 2, ACT_SWIGLU_OAI = 3 };

// -- 1. align -----------------------------------------------------------------

__global__ void __launch_bounds__(kAlignThreads)
    align_kernel(const int* __restrict__ topi, int NK, int X,
                 int* __restrict__ sorted, int* __restrict__ tile_expert,
                 int* __restrict__ n_tiles) {
  extern __shared__ int hist[];   // X counts
  __shared__ int warp_cnt[kAlignThreads / 32];
  __shared__ int s_off, s_cnt;
  const int x = blockIdx.x;
  for (int i = threadIdx.x; i < X; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < NK; p += blockDim.x) {
    const int e = topi[p];
    if (e >= 0 && e < X) atomicAdd(&hist[e], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0, tiles = 0;
    for (int i = 0; i < X; ++i) {
      const int t = (hist[i] + BM - 1) / BM;
      if (i < x) off += t * BM;
      tiles += t;
    }
    s_off = off;
    s_cnt = hist[x];
    if (x == 0) *n_tiles = tiles;
  }
  __syncthreads();
  const int off = s_off, cnt = s_cnt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int done = 0;   // this expert's pairs placed by earlier chunks
  for (int b = 0; b < NK; b += kAlignThreads) {
    const int p = b + threadIdx.x;
    const bool mine = p < NK && topi[p] == x;
    const unsigned bal = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int before = done, total = 0;
    for (int w = 0; w < kAlignThreads / 32; ++w) {
      if (w < warp) before += warp_cnt[w];
      total += warp_cnt[w];
    }
    if (mine) sorted[off + before + __popc(bal & ((1u << lane) - 1u))] = p;
    done += total;
    __syncthreads();   // warp_cnt is rewritten by the next chunk
  }
  const int padded = (cnt + BM - 1) / BM * BM;
  for (int i = cnt + threadIdx.x; i < padded; i += blockDim.x)
    sorted[off + i] = -1;
  for (int t = threadIdx.x; t < padded / BM; t += blockDim.x)
    tile_expert[off / BM + t] = x;
}

// -- the tile core: BM x BN, f32 accumulators, mma.sync ------------------------

// a BM x BK bf16 tile of rows src_row[r] (-1: zeros) of a [., ld] matrix,
// columns k0.., zero past kmax; 256 chunks of 16 bytes, 2 a thread
__device__ __forceinline__ void load_a(bf16 (*As)[LDA], const bf16* base,
                                       const int* src_row, long ld, int k0,
                                       int kmax) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2, col = (c & 3) * 8;
    const int sr = src_row[r];
    const bool ok = sr >= 0 && k0 + col < kmax;
    const bf16* src = ok ? base + (long)sr * ld + k0 + col : base;
    lbt_cp16(&As[r][col], src, ok);
  }
}

// a BK x BN bf16 tile of a [kmax, nmax] row-major matrix at (k0, n0), zero
// outside; 256 chunks, 2 a thread
__device__ __forceinline__ void load_b(bf16 (*Bs)[LDB], const bf16* base,
                                       int k0, int n0, int kmax, int nmax) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 3, col = (c & 7) * 8;
    const bool ok = k0 + r < kmax && n0 + col < nmax;
    const bf16* src = ok ? base + (long)(k0 + r) * nmax + n0 + col : base;
    lbt_cp16(&Bs[r][col], src, ok);
  }
}

// acc[j] += A(warp's 16 rows, k16 step kk) . B(k16 step kk, fragment j)
__device__ __forceinline__ void mma_step(float (&acc)[8][4],
                                         const bf16 (*As)[LDA],
                                         const bf16 (*Bs)[LDB], int kk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t a[4];
  lbt_ldsm4(a, &As[warp * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    uint32_t b[4];
    lbt_ldsm4_t(b, &Bs[kk + (lane & 15)][jb * 16 + (lane >> 4) * 8]);
    const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
    lbt_mma_bf16(acc[2 * jb], a, b0);
    lbt_mma_bf16(acc[2 * jb + 1], a, b1);
  }
}

template <int ACT>
__device__ __forceinline__ float activate(float g, float u) {
  if constexpr (ACT == ACT_SWIGLU_OAI) {
    g = fminf(g, 7.0f);
    u = fminf(fmaxf(u, -7.0f), 7.0f);
    return (u + 1.0f) * g * (1.0f / (1.0f + expf(-(g * 1.702f))));
  } else if constexpr (ACT == ACT_GELU) {
    const float t = tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g));
    return 0.5f * g * (1.0f + t) * u;
  } else if constexpr (ACT == ACT_RELU2) {
    const float r = fmaxf(g, 0.0f);
    return r * r * u;
  } else {
    return g / (1.0f + expf(-g)) * u;
  }
}

// -- 2. gate_up -----------------------------------------------------------------

template <int ACT>
__global__ void __launch_bounds__(kThreads)
    gate_up_kernel(const bf16* __restrict__ h, const int* __restrict__ sorted,
                   const int* __restrict__ tile_expert,
                   const int* __restrict__ n_tiles,
                   const float* __restrict__ topv, const bf16* __restrict__ wg,
                   const bf16* __restrict__ wu, const float* __restrict__ bg,
                   const float* __restrict__ bu, bf16* __restrict__ act_hi,
                   bf16* __restrict__ act_lo, int K, int E, int F,
                   int weight_before) {
  const int tile = blockIdx.x;
  if (tile >= *n_tiles) return;
  const int x = tile_expert[tile];
  const int n0 = blockIdx.y * BN;
  __shared__ alignas(16) bf16 As[2][BM][LDA];
  __shared__ alignas(16) bf16 Bg[2][BK][LDB];
  __shared__ alignas(16) bf16 Bu[2][BK][LDB];
  __shared__ int src_row[BM];
  __shared__ float row_w[BM];
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int p = sorted[(long)tile * BM + r];
    src_row[r] = p >= 0 ? p / K : -1;
    row_w[r] = p >= 0 ? topv[p] : 0.0f;
  }
  __syncthreads();
  const bf16* g_base = wg + (long)x * E * F;
  const bf16* u_base = wu + (long)x * E * F;
  float ag[8][4] = {}, au[8][4] = {};
  const int nk = (E + BK - 1) / BK;
  load_a(As[0], h, src_row, E, 0, E);
  load_b(Bg[0], g_base, 0, n0, E, F);
  load_b(Bu[0], u_base, 0, n0, E, F);
  lbt_cp_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      const int k1 = (kt + 1) * BK;
      load_a(As[st ^ 1], h, src_row, E, k1, E);
      load_b(Bg[st ^ 1], g_base, k1, n0, E, F);
      load_b(Bu[st ^ 1], u_base, k1, n0, E, F);
    }
    lbt_cp_commit();
    lbt_cp_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      mma_step(ag, As[st], Bg[st], kk);
      mma_step(au, As[st], Bu[st], kk);
    }
    __syncthreads();   // the stage is refilled next iteration
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    if (col >= F) continue;   // F % 8 == 0: col + 1 < F too
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + (lane >> 2) + half * 8;
      if (src_row[r] < 0) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float g = ag[j][2 * half + e], u = au[j][2 * half + e];
        if (weight_before) {
          g *= row_w[r];
          u *= row_w[r];
        }
        if (bg != nullptr) {
          g += bg[(long)x * F + col + e];
          u += bu[(long)x * F + col + e];
        }
        v[e] = activate<ACT>(g, u);
      }
      const uint32_t hi = lbt_pack_bf16(v[0], v[1]);
      const bf16* hp = reinterpret_cast<const bf16*>(&hi);
      const uint32_t lo = lbt_pack_bf16(v[0] - __bfloat162float(hp[0]),
                                        v[1] - __bfloat162float(hp[1]));
      const long o = ((long)tile * BM + r) * F + col;
      *reinterpret_cast<uint32_t*>(act_hi + o) = hi;
      *reinterpret_cast<uint32_t*>(act_lo + o) = lo;
    }
  }
}

// -- 3. down --------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    down_kernel(const bf16* __restrict__ act_hi, const bf16* __restrict__ act_lo,
                const int* __restrict__ sorted,
                const int* __restrict__ tile_expert,
                const int* __restrict__ n_tiles, const bf16* __restrict__ wd,
                const float* __restrict__ bd, float* __restrict__ pair_out,
                int E, int F) {
  const int tile = blockIdx.x;
  if (tile >= *n_tiles) return;
  const int x = tile_expert[tile];
  const int n0 = blockIdx.y * BN;
  __shared__ alignas(16) bf16 Ah[2][BM][LDA];
  __shared__ alignas(16) bf16 Al[2][BM][LDA];
  __shared__ alignas(16) bf16 Bs[2][BK][LDB];
  __shared__ int pair[BM], src_row[BM];
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    pair[r] = sorted[(long)tile * BM + r];
    src_row[r] = pair[r] >= 0 ? tile * BM + r : -1;
  }
  __syncthreads();
  const bf16* d_base = wd + (long)x * F * E;
  float acc[8][4] = {};
  const int nk = (F + BK - 1) / BK;
  load_a(Ah[0], act_hi, src_row, F, 0, F);
  load_a(Al[0], act_lo, src_row, F, 0, F);
  load_b(Bs[0], d_base, 0, n0, F, E);
  lbt_cp_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      const int k1 = (kt + 1) * BK;
      load_a(Ah[st ^ 1], act_hi, src_row, F, k1, F);
      load_a(Al[st ^ 1], act_lo, src_row, F, k1, F);
      load_b(Bs[st ^ 1], d_base, k1, n0, F, E);
    }
    lbt_cp_commit();
    lbt_cp_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      mma_step(acc, Ah[st], Bs[st], kk);
      mma_step(acc, Al[st], Bs[st], kk);
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    if (col >= E) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + (lane >> 2) + half * 8;
      const int p = pair[r];
      if (p < 0) continue;
      float2 v = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      if (bd != nullptr) {
        v.x += bd[(long)x * E + col];
        v.y += bd[(long)x * E + col + 1];
      }
      *reinterpret_cast<float2*>(pair_out + (long)p * E + col) = v;
    }
  }
}

// -- 4. combine -----------------------------------------------------------------

__global__ void __launch_bounds__(kCombineThreads)
    combine_kernel(const int* __restrict__ topi, const float* __restrict__ topv,
                   const float* __restrict__ pair_out, float* __restrict__ y,
                   int K, int E, int weighted, float scale) {
  __shared__ int ord[kMaxPicks];
  __shared__ float wt[kMaxPicks];
  const long n = blockIdx.x;
  if (threadIdx.x == 0) {
    // the row's picks by ascending expert index (insertion sort; the
    // experts of a row are distinct)
    for (int k = 0; k < K; ++k) {
      const int e = topi[n * K + k];
      int j = k;
      while (j > 0 && topi[n * K + ord[j - 1]] > e) {
        ord[j] = ord[j - 1];
        --j;
      }
      ord[j] = k;
    }
    for (int j = 0; j < K; ++j) wt[j] = topv[n * K + ord[j]];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < E; c += kCombineThreads) {
    float s = 0.0f;
    for (int j = 0; j < K; ++j) {
      float t = pair_out[(n * K + ord[j]) * E + c];
      if (weighted) t = __fmul_rn(t, wt[j]);
      s = j == 0 ? t : __fadd_rn(s, t);
    }
    if (scale != 1.0f) s = __fmul_rn(s, scale);
    y[n * E + c] = s;
  }
}

template <int ACT>
int launch_gate_up(dim3 grid, cudaStream_t st, const bf16* h, const int* sorted,
                   const int* tile_expert, const int* n_tiles,
                   const float* topv, const bf16* wg, const bf16* wu,
                   const float* bg, const float* bu, bf16* act_hi,
                   bf16* act_lo, int K, int E, int F, int weight_before) {
  gate_up_kernel<ACT><<<grid, kThreads, 0, st>>>(
      h, sorted, tile_expert, n_tiles, topv, wg, wu, bg, bu, act_hi, act_lo,
      K, E, F, weight_before);
  return (int)cudaGetLastError();
}

}  // namespace

// h [N, E] bf16; topi [N, K] int32 (distinct experts a row, in [0, X));
// topv [N, K] f32; wg, wu [X, E, F] and wd [X, F, E] bf16; bg, bu [X, F]
// and bd [X, E] f32 or null (bg and bu together); scratch: sorted [P]
// int32, tile_expert [max(T, 1)] int32, n_tiles [1] int32, act [2, P, F]
// bf16, pair_out [N K, E] f32, with T = (N K + X (BM - 1)) / BM and P = T
// BM; y [N, E] f32. act: 0 silu, 1 gelu (tanh), 2 relu2, 3 swiglu_oai.
// E and F multiples of 8, every pointer 16-byte aligned and contiguous on
// the device; 1 <= K <= min(X, 64). Returns cudaGetLastError() after the
// last launch, or -1 for a configuration the kernels do not take.
extern "C" int lbt_moe_ffn(const void* h, const void* topi, const void* topv,
                           const void* wg, const void* wu, const void* wd,
                           const void* bg, const void* bu, const void* bd,
                           void* sorted, void* tile_expert, void* n_tiles,
                           void* act, void* pair_out, void* y, int N, int K,
                           int X, int E, int F, int act_kind,
                           int weight_before, float scale, void* stream) {
  if (N < 0 || K < 1 || K > kMaxPicks || K > X || E < 8 || F < 8 ||
      E % 8 || F % 8 || act_kind < 0 || act_kind > 3 ||
      (bg == nullptr) != (bu == nullptr))
    return LBT_UNSUPPORTED;
  if (N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long NK = (long)N * K;
  const long T = (NK + (long)X * (BM - 1)) / BM;
  const long P = T * BM;
  if (NK > (1L << 30) || T > (1L << 30)) return LBT_UNSUPPORTED;
  int* s = (int*)sorted;
  int* te = (int*)tile_expert;
  int* nt = (int*)n_tiles;
  bf16* act_hi = (bf16*)act;
  bf16* act_lo = act_hi + P * F;
  align_kernel<<<X, kAlignThreads, X * sizeof(int), st>>>(
      (const int*)topi, (int)NK, X, s, te, nt);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const dim3 g1((unsigned)T, (unsigned)((F + BN - 1) / BN));
  auto gu = [&](auto fn) {
    return fn(g1, st, (const bf16*)h, s, te, nt, (const float*)topv,
              (const bf16*)wg, (const bf16*)wu, (const float*)bg,
              (const float*)bu, act_hi, act_lo, K, E, F, weight_before);
  };
  switch (act_kind) {
    case ACT_SILU: rc = gu(launch_gate_up<ACT_SILU>); break;
    case ACT_GELU: rc = gu(launch_gate_up<ACT_GELU>); break;
    case ACT_RELU2: rc = gu(launch_gate_up<ACT_RELU2>); break;
    default: rc = gu(launch_gate_up<ACT_SWIGLU_OAI>); break;
  }
  if (rc) return rc;
  const dim3 g2((unsigned)T, (unsigned)((E + BN - 1) / BN));
  down_kernel<<<g2, kThreads, 0, st>>>(act_hi, act_lo, s, te, nt,
                                       (const bf16*)wd, (const float*)bd,
                                       (float*)pair_out, E, F);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  combine_kernel<<<(unsigned)N, kCombineThreads, 0, st>>>(
      (const int*)topi, (const float*)topv, (const float*)pair_out,
      (float*)y, K, E, weight_before ? 0 : 1, scale);
  return (int)cudaGetLastError();
}
