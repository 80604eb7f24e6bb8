// Shared pieces of the w8a8 kernels (w8a8_matmul.cu, fused_norm_qmm.cu,
// fused_layer_tail.cu).
//
// Per-row symmetric int8 activations, exactly ops/qmatmul._quant_rows:
// xs = max(amax, 1e-12) / 127 and codes clip(rint(x / xs), -127, 127),
// with IEEE division and round-half-to-even (no reciprocal multiply, no
// fast math), so the codes equal torch.round(x / xs) bit for bit. The
// row max propagates NaN, as torch.amax does, so a NaN that reaches a row
// shows in its outputs.
//
// The decode-width streaming core of the fused kernels (stream_gemm): at
// R <= 64 rows every weight byte feeds R multiply-adds, so the kernels are
// bound by the weight bytes, and the card needs about 18 KB in flight on
// each SM to reach its memory rate.
// - A block owns 128 output columns (the gate|up phase: 64 gate columns and
//   the 64 up columns paired with them), RP rows (R rounded up to 1, 2, 4
//   or 8, halved while a block would leave no room for a second on its SM;
//   one grid row group per RP rows) and one split of the in-dim: a run
//   of whole 64-row tiles, the last one ragged where K is not a multiple of
//   64. The split count comes from the weight's shape alone
//   (ops/fused_decode._splits), so the blocks fill a wave of the card.
// - Weight tiles of 64 rows x 128 columns (8 KB) stream through a ring of
//   kStages shared-memory stages by cp.async: kStages - 2 tiles (32 KB) are
//   in flight beyond the one being summed. Copies are VEC bytes (16, or 8 /
//   4 where a row or column offset is only that aligned); columns and rows
//   past the matrix are zero-filled and never written.
// - Each block needs its rows' int8 codes, and so each row's scale over the
//   whole row (and the rms norm first, with NORM). Every block stages its
//   rows (and the norm weight) in shared memory with all loads in flight
//   at once; a normal launch issues them before its weight stages, so they
//   do not queue behind 40 KB of weights. Then one warp per row computes
//   the row's scale, lanes on fixed strides and a fixed shuffle tree, so a
//   row's codes do not depend on R or on the split, and the block keeps
//   its split's codes.
//   In the tail's phase C the rows' max |act| comes from phase B's
//   epilogue (kAmaxRaise), so a block stages only its split of each row.
// - A programmatic dependent (the tail's phases B and C) issues its weight
//   stages first, then griddepcontrol.launch_dependents lets the next
//   phase start its own, and griddepcontrol.wait waits for the previous
//   phase's rows before any activation is read.
// - Warp w sums rows 8w .. 8w+7 of every tile, lane l columns 4l .. 4l+3:
//   4 x 4 weight bytes are transposed in registers (__byte_perm) so each
//   word holds 4 consecutive k of one column, and __dp4a takes them against
//   each row's code word. The 8 warps' sums are added in shared memory in a
//   fixed order.
// - With one split the block runs the epilogue itself. Otherwise it adds
//   its int32 sums into the per-device accumulator (red.global.add) and
//   takes a ticket from its column tile's counter; the block that arrives
//   last reads the sums, zeroes them and the counter for the next call, and
//   runs the epilogue. Integer sums are exact in any order, so the output's
//   bits do not depend on the split count, the arrival order or the other
//   rows of the call.
#pragma once

#include "common.cuh"

namespace lbt_w8 {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;

// max that keeps a NaN from either side
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(amax, 1e-12f) / 127.0f;
}

__device__ __forceinline__ int8_t code(float h, float xs) {
  float q = rintf(h / xs);
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (int8_t)q;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nanmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// 4 words = rows k..k+3 of 4 consecutive int8 columns -> 4 words, word j
// holding column j's bytes for k..k+3 (byte i = row k+i)
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// -- the streaming core ----------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;                  // output columns a block owns
constexpr int kHalf = kTileN / 2;            // gate|up: gate / up columns
constexpr int kTileK = 64;                   // weight rows a stage
constexpr int kStages = 6;
constexpr int kStageBytes = kTileK * kTileN;  // 8 KB
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMaxSmem = 232448 - 1024;      // 227 KB less the static bytes
constexpr size_t kTwoBlockSmem = 113 * 1024;  // leaves room for a second block

// bytes of p staged rows of ld bf16 elements, rounded up to 16
__host__ __device__ constexpr size_t rows_bytes(int p, int ld) {
  return ((size_t)p * ld * 2 + 15) / 16 * 16;
}

// the epilogue: out = bf16(acc * xs * ws) (kRescale); + the residual,
// bf16(res + bf16(bf16(acc * xs * ws) * rs)) (kResid); bf16(act(g) * u)
// of the paired gate and up columns, each rounded to bf16 (kGateUp)
enum Epi { kRescale = 0, kResid = 1, kGateUp = 2 };
enum { kSilu = 0, kGelu = 1, kRelu2 = 2 };
// the tail's row maxima of |act|: phase A zeroes them, phase B's epilogue
// raises them (atomicMax on the f32 bits: exact, in any order; NaN above
// every number, as nanmax), phase C reads them instead of its whole rows
enum Amax { kAmaxNone = 0, kAmaxClear = 1, kAmaxRaise = 2, kAmaxRead = 3 };

struct StreamArgs {
  const bf16* x;     // [R, K] rows
  const void* nw;    // [K] norm weight (NORM), bf16 or f32
  const int8_t* w;   // [K, ldw] codes; gate|up: gate column n, up FF + n
  const float* ws;   // [ldw] column scales
  const bf16* res;   // [R, N] residual (kResid)
  bf16* out;         // [R, N]
  int* acc;          // split sums [row groups][column tiles][RP][128]
  unsigned* cnt;     // tickets [row groups][column tiles]
  int R, K, N, ldw;  // N output columns (gate|up: FF)
  int code_ld;       // code bytes a row keeps: the longest split
  float eps, rs;
  int act;
  unsigned* amax;    // [R] row maxima of |act| as f32 bits (the tail)
  int amax_mode;     // kAmaxNone, or what this phase does with amax
  int pdl;           // launched as a programmatic dependent
  int rows_ld;       // row elements staged in shared memory a row
};

// ops/fused_decode._act_f32 on f32 (silu and tanh-gelu as torch's kernels)
__device__ __forceinline__ float act_f32(float g, int act) {
  if (act == kGelu) {
    const float kBeta = 0.7978845608028654f;   // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    return 0.5f * g * (1.0f + tanhf(kBeta * (g + kKappa * g * g * g)));
  }
  if (act == kRelu2) {
    const float r = g < 0.f ? 0.f : g;   // NaN stays NaN
    return r * r;
  }
  return g / (1.0f + expf(-g));
}

// programmatic dependent launch (sm_90): both are no-ops for a kernel
// launched without the attribute / without a dependent
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// VEC bytes global -> shared, zero-filled when !ok (src is not read then)
template <int VEC>
__device__ __forceinline__ void cp_vec(void* dst, const void* src, bool ok) {
  if constexpr (VEC == 16) {
    lbt_cp16(dst, src, ok);
  } else if constexpr (VEC == 8) {
    lbt_cp8(dst, src, ok);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     lbt_smem(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

// 4 consecutive values in shared memory (8-byte aligned bf16, 16-byte
// aligned f32) as f32
__device__ __forceinline__ void ld4(const bf16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

// One warp: a row staged in shared memory (xr, from element 0) -> its
// 1 / rms (1 without NORM) and int8 scale. With NORM the row is first
// rms-normed as ops/fused_decode._rms_bf16: f32 mean of squares, 1 /
// sqrtf(var + eps) (IEEE sqrt and division), times nw (NT, bf16 or f32,
// staged) in f32, one rounding to bf16. Lane l takes k = 4l + e + 128 i and
// keeps one sum and one max for each e (four independent chains); the
// four meet in a fixed order and the lanes in a fixed shuffle tree, so the
// result depends on the row and K alone. With amax >= 0 the row's max
// |value| is given (only the block's split of the row is staged).
template <bool NORM, typename NT>
__device__ __forceinline__ float2 row_stats(const bf16* xr, int K,
                                            const NT* nw, float eps,
                                            float amax) {
  const int lane = threadIdx.x & 31;
  float inv = 1.f;
  if constexpr (NORM) {
    float ss[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 4 * lane; k < K; k += 128) {
      float v[4];
      ld4(xr + k, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) ss[e] = fmaf(v[e], v[e], ss[e]);
    }
    const float sum = warp_sum((ss[0] + ss[1]) + (ss[2] + ss[3]));
    inv = 1.0f / sqrtf(sum / (float)K + eps);
  }
  if (amax < 0.f) {
    float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 4 * lane; k < K; k += 128) {
      float h[4];
      ld4(xr + k, h);
      if constexpr (NORM) {
        float g[4];
        ld4(nw + k, g);
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] = lbt_round<bf16>((h[e] * inv) * g[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e] = nanmax(m[e], fabsf(h[e]));
    }
    amax = warp_max(nanmax(nanmax(m[0], m[1]), nanmax(m[2], m[3])));
  }
  return make_float2(inv, row_scale(amax));
}

// the block of column tile blockIdx.x, split blockIdx.y (of gridDim.y) and
// row group blockIdx.z: see the notes at the top of this file
template <int EPI, bool NORM, typename NT, int RP, int VEC>
__device__ __forceinline__ void stream_gemm(const StreamArgs& a) {
  static_assert(RP >= 1 && RP <= kWarps && (kWarps % RP) == 0, "rows");
  static_assert(kWarps * RP * kTileN * 4 <= kRingBytes, "reduction buffer");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float xs[RP];
  __shared__ int is_last;
  int8_t* const ring = reinterpret_cast<int8_t*>(smem);
  int8_t* const codes = ring + kRingBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, S = gridDim.y, r0 = blockIdx.z * RP;
  const int kt = (a.K + kTileK - 1) / kTileK;
  const int t0 = (int)((long)kt * blockIdx.y / S);
  const int nt = (int)((long)kt * (blockIdx.y + 1) / S) - t0;
  const int n0 = EPI == kGateUp ? tile * kHalf : tile * kTileN;

  // weight tile t -> stage i: [64 rows][128 columns] (gate|up: the 64 gate
  // columns, then their 64 up columns)
  auto stage = [&](int t, int i) {
    int8_t* dst = ring + i * kStageBytes;
    constexpr int kChunks = kTileN / VEC;
    static_assert(kTileK * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
    for (int u = 0; u < kTileK * kChunks / kThreads; ++u) {
      const int j = tid + u * kThreads;
      const int r = j / kChunks, c = (j % kChunks) * VEC;
      const int k = t * kTileK + r;
      int col;
      bool ok;
      if constexpr (EPI == kGateUp) {
        const int n = n0 + (c % kHalf);
        ok = n < a.N;
        col = (c < kHalf ? 0 : a.N) + n;
      } else {
        col = n0 + c;
        ok = col < a.N;
      }
      ok = ok && k < a.K;
      cp_vec<VEC>(dst + r * kTileN + c,
                  a.w + (ok ? (long)k * a.ldw + col : 0L), ok);
    }
  };
  auto stages = [&]() {
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < nt) stage(t0 + i, i);
      lbt_cp_commit();
    }
  };

  // the block's rows (elements [ka, ka + kw) of each: the whole row unless
  // phase C's row maxima are given) and the norm weight, staged in shared
  // memory by 8-byte cp.async copies, all in flight at once: a normal
  // launch issues them before its weight stages, so they do not queue
  // behind them; a programmatic dependent issues its stages first and
  // reads rows only once the previous kernel has completed
  const bool given = a.amax_mode == kAmaxRead;
  const int ka = given ? t0 * kTileK : 0;
  const int kw = given ? min(nt * kTileK, a.K - ka) : a.K;
  bf16* const xrow = reinterpret_cast<bf16*>(codes + RP * a.code_ld);
  NT* const nws = reinterpret_cast<NT*>(
      reinterpret_cast<unsigned char*>(xrow) + rows_bytes(RP, a.rows_ld));
  auto rows = [&]() {
    const int rch = kw / 4;                    // 8-byte chunks a row
    const int nrow = RP * rch;
    const int total = nrow + (NORM ? a.K * (int)sizeof(NT) / 8 : 0);
    for (int j = tid; j < total; j += kThreads) {
      if (j < nrow) {
        const int r = j / rch, c = 4 * (j - r * rch), row = r0 + r;
        const bool ok = row < a.R;
        lbt_cp8(xrow + r * a.rows_ld + c,
                a.x + (ok ? (long)row * a.K + ka + c : 0L), ok);
      } else {
        lbt_cp8(reinterpret_cast<uint2*>(nws) + (j - nrow),
                reinterpret_cast<const uint2*>(a.nw) + (j - nrow), true);
      }
    }
    lbt_cp_commit();
  };
  // a programmatic dependent's rows are the newest group (and it waits for
  // all), a normal launch's the oldest: either way only the ring's own
  // groups are pending when the loop below starts
  if (a.pdl) {
    stages();
    griddep_launch_dependents();
    griddep_wait();
    rows();
    lbt_cp_wait<0>();
  } else {
    rows();
    stages();
    griddep_launch_dependents();
    lbt_cp_wait<kStages - 1>();
  }
  if (a.amax_mode == kAmaxClear && blockIdx.x + blockIdx.y + blockIdx.z == 0)
    for (int r = tid; r < a.R; r += kThreads) a.amax[r] = 0u;
  __syncthreads();
  // one warp per row: 1 / rms and scale; then every thread: the codes of
  // the split, 4 at a time
  __shared__ float2 stats[RP];
  if (warp < RP) {
    const int row = r0 + warp;
    float2 st = make_float2(1.f, 0.f);
    if (row < a.R)
      st = row_stats<NORM, NT>(
          xrow + warp * a.rows_ld, a.K, nws, a.eps,
          given ? __uint_as_float(__ldcg(a.amax + row)) : -1.f);
    if (lane == 0) {
      stats[warp] = st;
      xs[warp] = st.y;
    }
  }
  __syncthreads();
  {
    const int k0 = t0 * kTileK, quads = nt * kTileK / 4;
    for (int j = tid; j < RP * quads; j += kThreads) {
      const int r = j / quads, k = 4 * (j - r * quads);
      uint32_t word = 0u;
      if (r0 + r < a.R && k0 + k < a.K) {
        const float inv = stats[r].x, s = stats[r].y;
        float h[4];
        ld4(xrow + r * a.rows_ld + (k0 + k - ka), h);
        if constexpr (NORM) {
          float g[4];
          ld4(nws + k0 + k, g);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            h[e] = lbt_round<bf16>((h[e] * inv) * g[e]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          word |= (uint32_t)(uint8_t)code(h[e], s) << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(codes + r * a.code_ld + k) = word;
    }
  }

  // the ring: tile it + kStages - 1 is issued once every thread is past
  // tile it - 1, whose stage it refills
  int acc[RP][4];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0;
  for (int it = 0; it < nt; ++it) {
    lbt_cp_wait<kStages - 2>();   // tile it has landed
    __syncthreads();
    const int nx = it + kStages - 1;
    if (nx < nt) stage(t0 + nx, nx % kStages);
    lbt_cp_commit();
    const int8_t* wt =
        ring + (it % kStages) * kStageBytes + warp * 8 * kTileN + 4 * lane;
    const int8_t* at = codes + it * kTileK + warp * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t c[4];
      transpose4(*reinterpret_cast<const uint32_t*>(wt + (4 * h) * kTileN),
                 *reinterpret_cast<const uint32_t*>(wt + (4 * h + 1) * kTileN),
                 *reinterpret_cast<const uint32_t*>(wt + (4 * h + 2) * kTileN),
                 *reinterpret_cast<const uint32_t*>(wt + (4 * h + 3) * kTileN),
                 c);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int av =
            *reinterpret_cast<const int*>(at + r * a.code_ld + 4 * h);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a(av, (int)c[j], acc[r][j]);
      }
    }
  }
  lbt_cp_wait<0>();
  __syncthreads();   // the ring is free: it becomes the reduction buffer

  // red[w][r][c]: warp w's sums; then red[r][c] (w = 0) the block's
  constexpr int kElems = RP * kTileN;
  int* const red = reinterpret_cast<int*>(ring);
#pragma unroll
  for (int r = 0; r < RP; ++r)
    *reinterpret_cast<int4*>(red + (warp * RP + r) * kTileN + 4 * lane) =
        make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  // element i of the tile (row i / 128, tile column i % 128) is in range
  auto valid = [&](int i) {
    const int c = i % kTileN;
    return r0 + i / kTileN < a.R &&
           n0 + (EPI == kGateUp ? c % kHalf : c) < a.N;
  };
  for (int i = tid; i < kElems; i += kThreads) {
    int v = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w * kElems + i];
    red[i] = v;
  }
  if (S > 1) {
    int* const acc_g = a.acc + (long)(blockIdx.z * gridDim.x + tile) * kElems;
    for (int i = tid; i < kElems; i += kThreads)
      if (valid(i)) atomicAdd(acc_g + i, red[i]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      unsigned* c = a.cnt + blockIdx.z * gridDim.x + tile;
      const bool last = atomicAdd(c, 1u) == (unsigned)(S - 1);
      if (last) atomicExch(c, 0u);
      is_last = last;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    for (int i = tid; i < kElems; i += kThreads)
      if (valid(i)) {
        red[i] = __ldcg(acc_g + i);
        __stcg(acc_g + i, 0);
      }
  }
  __syncthreads();

  const float rsb = lbt_round<bf16>(a.rs);
  constexpr int kOut = EPI == kGateUp ? kHalf : kTileN;
  static_assert(kOut % 32 == 0, "a warp's outputs lie in one row");
  for (int i = tid; i < RP * kOut; i += kThreads) {
    const int r = i / kOut, c = i % kOut, n = n0 + c, row = r0 + r;
    const bool ok = row < a.R && n < a.N;
    const long o = (long)row * a.N + n;
    const int* sums = red + r * kTileN;
    if constexpr (EPI == kGateUp) {
      float m = 0.f;   // |act| of the row, for phase C's codes
      if (ok) {
        const float g = lbt_round<bf16>((float)sums[c] * xs[r] * a.ws[n]);
        const float u =
            lbt_round<bf16>((float)sums[kHalf + c] * xs[r] * a.ws[a.N + n]);
        const bf16 h = __float2bfloat16(act_f32(g, a.act) * u);
        a.out[o] = h;
        m = fabsf(lbt_f(h));
      }
      if (a.amax_mode == kAmaxRaise) {
        m = warp_max(m);
        if (ok && (tid & 31) == 0) atomicMax(a.amax + row, __float_as_uint(m));
      }
    } else if (!ok) {
      continue;
    } else if constexpr (EPI == kResid) {
      const float v = lbt_round<bf16>((float)sums[c] * xs[r] * a.ws[n]);
      const float x0 = __uint_as_float(
          (uint32_t)__ldcg(reinterpret_cast<const unsigned short*>(a.res + o))
          << 16);
      a.out[o] = __float2bfloat16(x0 + lbt_round<bf16>(v * rsb));
    } else {
      a.out[o] = __float2bfloat16((float)sums[c] * xs[r] * a.ws[n]);
    }
  }
}

// -- host side -----------------------------------------------------------------

// the widest copy (16, 8 or 4 bytes) that every row and column offset of
// the weight allows: its address, its row length and (gate|up) the up
// columns' offset
__host__ inline int copy_bytes(const void* w, int ldw, int up) {
  const unsigned long g = (unsigned long)w | (unsigned)ldw | (unsigned)up;
  return g % 16 == 0 ? 16 : g % 8 == 0 ? 8 : 4;
}

// the launch geometry of one call (`tile_cols` output columns a block:
// 128, or 64 for gate|up; nw_bytes: the norm weight's element size, 0
// without a norm): the rows a block takes (R rounded up to 1, 2, 4 or 8,
// halved while a block would leave no room for a second one on its SM),
// grid, dynamic shared memory (ring, codes, staged rows, norm weight) and
// the code and staged row lengths; false when the split count is out of
// range or one row does not fit a block
__host__ inline bool geometry(StreamArgs& a, int tile_cols, int splits,
                              size_t nw_bytes, int& rp, dim3& grid,
                              size_t& smem) {
  const int kt = (a.K + kTileK - 1) / kTileK;
  if (splits < 1 || splits > kt || splits > 65535) return false;
  if (splits > 1 && (!a.acc || !a.cnt)) return false;
  a.code_ld = (kt + splits - 1) / splits * kTileK;
  a.rows_ld = a.amax_mode == kAmaxRead ? a.code_ld : a.K;
  auto bytes = [&](int p) {
    return (size_t)kRingBytes + (size_t)p * a.code_ld +
           rows_bytes(p, a.rows_ld) + (size_t)a.K * nw_bytes;
  };
  rp = a.R <= 1 ? 1 : a.R <= 2 ? 2 : a.R <= 4 ? 4 : 8;
  while (rp > 1 && bytes(rp) > kTwoBlockSmem) rp /= 2;
  smem = bytes(rp);
  if (smem > (size_t)kMaxSmem) return false;
  grid = dim3((a.N + tile_cols - 1) / tile_cols, splits, (a.R + rp - 1) / rp);
  return true;
}

// launch kern with `a`, through cudaLaunchKernelEx; with `pdl` as a
// programmatic dependent of the previous kernel on the stream. The
// kernel's dynamic shared memory limit is raised once per device (DONE is
// the instantiation's own flag word).
template <typename Kern>
int launch_stream(Kern kern, unsigned& done, dim3 grid, size_t smem,
                  bool pdl, const StreamArgs& a, cudaStream_t st) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(done >> dev & 1u)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) done |= 1u << dev;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace lbt_w8
