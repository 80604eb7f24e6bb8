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
// The dp4a row-tile GEMM of the fused kernels: a block owns 32 output
// columns (8 groups of 4) and 32 k-slices; thread (cg, ks) walks k = 4*ks,
// 4*ks + 128, ..., loads the 4 x 4 bytes of rows k..k+3 of its 4 columns
// (weights are [in, out], so consecutive k are `out` bytes apart),
// transposes them in registers with __byte_perm so that each word holds 4
// consecutive k of one column, and accumulates __dp4a against the row's
// codes in shared memory. The slices are summed in a fixed order (warp
// shuffles, then shared memory); integer sums are exact in any order, so
// a row's result does not depend on the other rows or on the tiling.
#pragma once

#include "common.cuh"

namespace lbt_w8 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColGroups = 8;                       // x 4 columns = 32
constexpr int kCols = 4 * kColGroups;
constexpr int kSlices = kThreads / kColGroups;      // 32 k-slices
constexpr int kRowGroup = 8;                        // rows per pass
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

// Rows r0 .. r0+rg-1 of x [R, K] (bf16) -> int8 codes xq [kRowGroup][K]
// and scales xs [kRowGroup] in shared memory, one warp per row. With
// NORM the row is first rms-normed as ops/fused_decode._rms_bf16: f32
// mean of squares, 1 / sqrtf(var + eps) (IEEE sqrt and division), times
// nw (of type NT, bf16 or f32) in f32, one rounding to bf16. Rows >= rg
// get zero codes. The row is read from global memory once per pass (sum
// of squares, max, codes) and the normed value is recomputed,
// identically, each time.
template <bool NORM, typename NT>
__device__ __forceinline__ void quant_rows(const __nv_bfloat16* __restrict__ x,
                                           int K, const NT* __restrict__ nw,
                                           float eps, int r0, int rg,
                                           int8_t* xq, float* xs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int8_t* q = xq + (long)warp * K;
  if (warp >= rg) {
    for (int k = lane; k < K; k += 32) q[k] = 0;
    if (lane == 0) xs[warp] = 0.f;
    return;
  }
  const __nv_bfloat16* row = x + (long)(r0 + warp) * K;
  float inv = 1.f;
  if constexpr (NORM) {
    float ss = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = lbt_f(row[k]);
      ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    inv = 1.0f / sqrtf(ss / (float)K + eps);
  }
  auto h = [&](int k) -> float {
    const float v = lbt_f(row[k]);
    if constexpr (NORM)
      return lbt_round<__nv_bfloat16>((v * inv) * lbt_f(nw[k]));
    return v;
  };
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) amax = nanmax(amax, fabsf(h(k)));
  const float s = row_scale(warp_max(amax));
  for (int k = lane; k < K; k += 32) q[k] = code(h(k), s);
  if (lane == 0) xs[warp] = s;
}

// acc[r][j] += sum over this thread's k-slice of xq[r][k] * w[k][col + j]
// for the kRowGroup rows in shared memory; w [K, ldw] int8, col a multiple
// of 4 (col_ok false: the columns lie past the matrix and are not read).
__device__ __forceinline__ void dp4a_slice(const int8_t* xq, int K,
                                           const int8_t* __restrict__ w,
                                           int ldw, int col, bool col_ok,
                                           int ks, int (&acc)[kRowGroup][4]) {
#pragma unroll 2
  for (int k = 4 * ks; k < K; k += 4 * kSlices) {
    uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
    if (col_ok) {
      const int8_t* p = w + (long)k * ldw + col;
      r0 = __ldg(reinterpret_cast<const uint32_t*>(p));
      r1 = __ldg(reinterpret_cast<const uint32_t*>(p + ldw));
      r2 = __ldg(reinterpret_cast<const uint32_t*>(p + 2L * ldw));
      r3 = __ldg(reinterpret_cast<const uint32_t*>(p + 3L * ldw));
    }
    uint32_t c[4];
    transpose4(r0, r1, r2, r3, c);
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      const int a = *reinterpret_cast<const int*>(xq + (long)r * K + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a(a, (int)c[j], acc[r][j]);
    }
  }
}

// Sum acc over the 32 k-slices in a fixed order: the 4 slices of a warp
// by shuffles (lanes 8 apart share a column group), then the 8 warps
// through red [kWarps][kRowGroup][kCols]. Afterwards red[0][r][c] holds
// the sum for row r, tile column c. Ends with __syncthreads().
__device__ __forceinline__ void reduce_slices(int (&acc)[kRowGroup][4],
                                              int* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = threadIdx.x % kColGroups;
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int v = acc[r][j];
      v += __shfl_xor_sync(kFull, v, 8);
      v += __shfl_xor_sync(kFull, v, 16);
      acc[r][j] = v;
    }
  if (lane < kColGroups) {
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[(warp * kRowGroup + r) * kCols + cg * 4 + j] = acc[r][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRowGroup * kCols; i += kThreads) {
    int v = red[i];
    for (int w = 1; w < kWarps; ++w) v += red[w * kRowGroup * kCols + i];
    red[i] = v;
  }
  __syncthreads();
}

// dynamic shared memory of one block: codes, scales, reduction buffer
__host__ __device__ inline size_t smem_bytes(int K) {
  const size_t codes = ((size_t)kRowGroup * K + 15) / 16 * 16;
  return codes + 16 * sizeof(float) +
         (size_t)kWarps * kRowGroup * kCols * sizeof(int);
}

}  // namespace lbt_w8
