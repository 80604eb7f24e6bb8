// The w8a8 matmul: per-row int8 activations, s8 x s8 -> s32 against
// per-column int8 weights, then (float(acc) * xs[m]) * ws[n], written as f32
// or as bf16 rounded once from that f32 (mm() asks for x's dtype).
//
// Replaces the function of _w8a8_matmul (llama_box_tpu/ops/qmatmul.py:158,
// lowered by XLA on the TPU) and its Pallas form qmm_kernel
// (scripts/probe_qmm_pallas.py:28): every projection of a prefill chunk,
// and of decode rows wherever the fused kernels do not take them.
//
// What bounds it: at prefill widths (M = 2048 rows of TinyLlama) int8
// operations, 2*M*K*N of them (94.5 GOP for gate|up, 48 us at the card's
// 1979 TOP/s); at decode widths the weight bytes.
//
// Design: two kernels a call, the second a programmatic dependent launch of
// the first.
// - quant_rows_kernel: one block of 128 threads a row. Where the row is
//   16-byte aligned and K a multiple of 8, each thread loads 8 values at a
//   time with 16-byte loads and keeps them in registers (rows up to 6144
//   values; the rest of a longer row is read again), the row's max |x| is
//   taken in registers (bf16 pairs two at a time, max.NaN.bf16x2), a
//   shuffle tree and shared memory, then each thread writes 8 codes at a
//   time. A code is rint(x * (1 / xs)), clamped, except within 1e-4 of a
//   rounding tie, where the IEEE division of lbt_w8::code decides: the
//   codes equal torch.round(x / xs) bit for bit. A row is padded with zero
//   codes to Kp, a multiple of 16 bytes. It lets its dependent start at
//   once.
// - Above 64 rows, w8a8_gemm_tma_kernel: BM x 128 output tiles (BM 128 or
//   256, chosen by shape in ops/qmatmul._w8a8_plan), K in steps of 128. For
//   8-bit types wgmma takes both operands K-major, and the weights stay
//   [in, out] as in the JAX layout (a second K-major copy would double
//   their memory). One producer warp streams the code tile and the raw
//   weight tile [128 k][128 n] of each step into a ring of shared-memory
//   stages by TMA (zeros past the edges, one mbarrier a stage counting the
//   bytes); two consumer warpgroups of BM / 2 rows issue wgmma m64n128k32
//   s8.s8.s32 on a tile while they transpose the next tile's raw weights
//   into a K-major copy (8 x 8 bytes a thread, __byte_perm; the raw tile
//   is read through a 3-D view of the weight that makes the 128-byte
//   swizzle XOR its chunks with k / 8, so both the loads and the stores of
//   the pass take two wavefronts a warp), double-buffered, then hand the
//   stage back. As a programmatic dependent the producer issues the first
//   stages' weights, then waits for the quant pass, then issues codes. The
//   sums go through shared memory so the epilogue writes whole rows. When
//   128-row tiles do not fill one wave of the card the in-dim is split
//   (_w8a8_plan, from the shape alone): each split writes its int32 sums
//   to a workspace, and the block that takes its tile's last ticket adds
//   them, runs the epilogue and resets the ticket.
// - Otherwise (at most 64 rows, or K not a multiple of 8, N of 16, or
//   weights not 16-byte aligned), w8a8_gemm_small_kernel: 64 x 64 tiles, 4
//   warps of 32 x 32, mma.sync.m16n8k32 on weights transposed in
//   registers, the in-dim split as above (up to four blocks an SM).
// Integer sums are exact in any order and the epilogue is per element, so
// the result equals the plain version's bit for bit and a row's bits do not
// depend on M, on the tile, on the split or on the kernel.
#include <cuda.h>

#include "q_common.cuh"
#include "w8a8_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using lbt_w8::code;
using lbt_w8::griddep_launch_dependents;
using lbt_w8::griddep_wait;
using lbt_w8::nanmax;
using lbt_w8::row_scale;
using lbt_w8::transpose4;
using lbt_w8::warp_max;

// -- the row-quantize pass -------------------------------------------------------

constexpr int kQuantThreads = 128;   // one block a row
constexpr int kQuantKeep = 6;        // 8-value units a thread keeps

// lbt_w8::code(h, s) with a multiply for most values: q = h * inv, inv =
// 1 / s, is within 2.3e-5 of h / s rounded (|q| <= 127 plus two roundings
// of 2**-24), so rint(q) equals rint(h / s) unless q lies within 1e-4 of a
// half-integer (`near`; there the IEEE division decides). The clamped code
// plus 1.5 * 2**23 holds it as its low byte (NaN gives -127, as code())
__device__ __forceinline__ uint32_t code_bits(float h, float inv, bool& near) {
  const float q = __fmul_rn(h, inv);
  const float r = rintf(q);
  near |= fabsf(fabsf(q - r) - 0.5f) < 1e-4f;
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(r, -127.0f), 127.0f), 12582912.0f));
}

// the low bytes of 4 words as one word
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// max of |bf16| pairs, NaN kept (the max is one of the values: exact)
__device__ __forceinline__ uint32_t absmax2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.NaN.bf16x2 %0, %1, %2;\n"
      : "=r"(r)
      : "r"(a & 0x7fff7fffu), "r"(b & 0x7fff7fffu));
  return r;
}

// the 8 values of a unit (8 consecutive elements: 1 word of bf16, 2 of
// f32) as f32
__device__ __forceinline__ void unit_vals(const uint4 (&w)[1],
                                          float (&f)[8]) {
  const uint32_t u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(u[j] << 16);
    f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unit_vals(const uint4 (&w)[2],
                                          float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(w[i].x);
    f[4 * i + 1] = __uint_as_float(w[i].y);
    f[4 * i + 2] = __uint_as_float(w[i].z);
    f[4 * i + 3] = __uint_as_float(w[i].w);
  }
}

// max |value| of a unit, NaN kept: bf16 pairs by absmax2 in a tree, f32
// by nanmax in a tree
__device__ __forceinline__ float unit_amax(const uint4 (&w)[1]) {
  const uint32_t m = absmax2(absmax2(w[0].x, w[0].y), absmax2(w[0].z, w[0].w));
  return nanmax(__uint_as_float(m << 16), __uint_as_float(m & 0xffff0000u));
}
__device__ __forceinline__ float unit_amax(const uint4 (&w)[2]) {
  float f[8];
  unit_vals(w, f);
#pragma unroll
  for (int h = 4; h > 0; h >>= 1)
#pragma unroll
    for (int e = 0; e < h; ++e)
      f[e] = h == 4 ? nanmax(fabsf(f[e]), fabsf(f[e + h]))
                    : nanmax(f[e], f[e + h]);
  return f[0];
}

// the unit's 8 codes; a unit with a value near a rounding tie is coded
// again with the division
template <int W>
__device__ __forceinline__ uint2 unit_codes(const uint4 (&w)[W], float s,
                                            float inv) {
  float f[8];
  unit_vals(w, f);
  uint32_t c[8];
  bool near = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) c[e] = code_bits(f[e], inv, near);
  if (near)
#pragma unroll
    for (int e = 0; e < 8; ++e) c[e] = (uint8_t)code(f[e], s);
  return make_uint2(pack4(c[0], c[1], c[2], c[3]),
                    pack4(c[4], c[5], c[6], c[7]));
}

// max over the block, the same value in every thread
__device__ __forceinline__ float block_max(float m) {
  __shared__ float part[kQuantThreads / 32];
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  m = part[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) m = nanmax(m, part[w]);
  return m;
}

// x [M, K] -> codes xq [M, Kp] (zero past K) and scales xs [M], block m
// taking row m. VEC: rows 16-byte aligned and K a multiple of 8; thread t
// loads units t, t + 128, .. of 8 values by 16-byte loads, keeps the first
// kQuantKeep in registers (rows up to 6144 values; the rest of a longer row
// is read again) and writes their 8 codes by 8-byte stores
template <typename XT, bool VEC>
__global__ void __launch_bounds__(kQuantThreads) quant_rows_kernel(
    const XT* __restrict__ x, int K, int Kp, int8_t* __restrict__ xq,
    float* __restrict__ xs) {
  griddep_launch_dependents();
  const int tid = threadIdx.x;
  const long m = blockIdx.x;
  const XT* row = x + m * K;
  int8_t* qrow = xq + m * Kp;
  float amax = 0.f;
  if constexpr (VEC) {
    constexpr int W = sizeof(XT) / 2;        // 16-byte words a unit
    const int units = K / 8;
    const uint4* src = reinterpret_cast<const uint4*>(row);
    auto load = [&](int i, uint4 (&w)[W]) {
#pragma unroll
      for (int j = 0; j < W; ++j) w[j] = __ldg(src + (long)i * W + j);
    };
    uint4 keep[kQuantKeep][W];
#pragma unroll
    for (int u = 0; u < kQuantKeep; ++u)
      if (u * kQuantThreads + tid < units) load(u * kQuantThreads + tid, keep[u]);
#pragma unroll
    for (int u = 0; u < kQuantKeep; ++u)
      if (u * kQuantThreads + tid < units) amax = nanmax(amax, unit_amax(keep[u]));
    for (int i = kQuantKeep * kQuantThreads + tid; i < units;
         i += kQuantThreads) {
      uint4 w[W];
      load(i, w);
      amax = nanmax(amax, unit_amax(w));
    }
    const float s = row_scale(block_max(amax)), inv = 1.0f / s;
    uint2* dst = reinterpret_cast<uint2*>(qrow);
#pragma unroll
    for (int u = 0; u < kQuantKeep; ++u)
      if (u * kQuantThreads + tid < units)
        dst[u * kQuantThreads + tid] = unit_codes<W>(keep[u], s, inv);
    for (int i = kQuantKeep * kQuantThreads + tid; i < units;
         i += kQuantThreads) {
      uint4 w[W];
      load(i, w);
      dst[i] = unit_codes<W>(w, s, inv);
    }
    if (tid == 0 && Kp > K) dst[units] = make_uint2(0u, 0u);
    if (tid == 0) xs[m] = s;
  } else {
    for (int k = tid; k < K; k += kQuantThreads)
      amax = nanmax(amax, fabsf(lbt_f(row[k])));
    const float s = row_scale(block_max(amax));
    for (int k = tid; k < Kp; k += kQuantThreads)
      qrow[k] = k < K ? code(lbt_f(row[k]), s) : (int8_t)0;
    if (tid == 0) xs[m] = s;
  }
}

// -- the epilogue ------------------------------------------------------------------

struct GemmArgs {
  const int8_t* xq;   // [M, Kp] codes
  const float* xs;    // [M] row scales
  const int8_t* w;    // [K, N] weight codes
  const float* ws;    // [N] column scales
  int* part;          // [splits, M, N] split sums (splits > 1)
  unsigned* cnt;      // tickets [row tiles][column tiles] (splits > 1)
  void* out;          // [M, N] f32 or bf16
  int M, K, Kp, N, out_bf16;
};

// out[row, col .. col + 3] = (float(acc) * xs) * ws, each product rounded,
// as f32 or rounded once to bf16
__device__ __forceinline__ void put4(const GemmArgs& a, long off, int4 v,
                                     float s, float4 w) {
  const float f0 = __fmul_rn(__fmul_rn((float)v.x, s), w.x);
  const float f1 = __fmul_rn(__fmul_rn((float)v.y, s), w.y);
  const float f2 = __fmul_rn(__fmul_rn((float)v.z, s), w.z);
  const float f3 = __fmul_rn(__fmul_rn((float)v.w, s), w.w);
  if (a.out_bf16)
    *reinterpret_cast<uint2*>(static_cast<bf16*>(a.out) + off) =
        make_uint2(lbt_pack_bf16(f0, f1), lbt_pack_bf16(f2, f3));
  else
    *reinterpret_cast<float4*>(static_cast<float*>(a.out) + off) =
        make_float4(f0, f1, f2, f3);
}

// after a block has written its split's sums to a.part: true in the block
// that takes its output tile's last ticket (it resets the ticket for the
// next call), with every split's sums visible to it
__device__ __forceinline__ bool last_of_split(const GemmArgs& a,
                                              int& is_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* t = a.cnt + blockIdx.y * gridDim.x + blockIdx.x;
    const bool last = atomicAdd(t, 1u) == gridDim.z - 1;
    if (last) atomicExch(t, 0u);
    is_last = last;
  }
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  return true;
}

// -- above 64 rows: TMA and wgmma --------------------------------------------------

constexpr int TN = 128, TK = 128;       // output columns, k a step
constexpr int kWTile = TK * TN;         // bytes of a raw or K-major weight tile
constexpr int kLdo = TN + 4;            // staged sums a row (ints)
constexpr int kMaxSplits = 8;
constexpr int kMaxSmem = 232448 - 1024;  // 227 KB less the static bytes
constexpr int kThreads = 288;           // warps 0-7 compute, warp 8 copies

// the ring of a BM-row block: (code tile, raw weight tile) stages, as many
// as fit beside Bt[2] and the column scales (6 of 32 KB, or 4 of 48 KB)
template <int BM>
__host__ __device__ constexpr int tma_stage() {
  return BM * TK + kWTile;
}
template <int BM>
__host__ __device__ constexpr int tma_stages() {
  return BM == 128 ? 6 : 4;
}
template <int BM>
__host__ __device__ constexpr size_t tma_smem() {
  return 1024 + 2 * kWTile + tma_stages<BM>() * tma_stage<BM>() +
         TN * sizeof(float);
}

// d += A . B for a warpgroup, m64n128k32, s8 x s8 -> s32, A and B K-major
// from shared memory. d[j][e]: n8 tile j, (row, column) as mma.sync's c[e]
// within the warp's 16 rows
__device__ __forceinline__ void wgmma_s8_128(int (&d)[16][4], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(lbt_smem(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   lbt_smem(b))
               : "memory");
}
// one arrival that also expects `bytes` of TMA copies before the phase ends
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(lbt_smem(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* b, unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(ok)
      : "r"(lbt_smem(b)), "r"(parity)
      : "memory");
  return ok != 0;
}
// wait for the phase of `parity` to complete; a copy that never lands
// traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  for (int i = 0; !mbar_try(b, parity); ++i)
    if (i == (1 << 22)) __trap();
}
// the eight compute warps only
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(lbt_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(lbt_smem(bar))
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(lbt_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(lbt_smem(bar))
      : "memory");
}

// BM x 128 output tiles (BM 128 or 256), split blockIdx.z of gridDim.z.
// Warp 8 streams each tile's codes (ta: [M, Kp] codes, a box of BM rows x
// 128 k, landing in wgmma's K-major 128-byte-swizzled layout: chunk c of
// row r at c ^ (r & 7)) and raw weights (tb: the weight [K, N] seen as
// [8 kk][K / 8 kg][N], a box of 8 x 16 x 128, so that row kk * 16 + kg of
// the stage holds weight row 8 kg + kk and the swizzle XORs its chunks
// with kg & 7) into the ring by TMA, one mbarrier a stage counting the
// bytes. Warps 0-7, two warpgroups of BM / 2 rows, issue a tile's wgmma,
// transpose the next tile's raw weights into the K-major Bt while the
// tensor cores run (thread (kb, nb) moves the 8 x 8 bytes k = 8kb ..,
// n = 8nb ..: 8 loads of 8 bytes, four 4 x 4 byte transposes, 8 stores of
// 8 bytes; both take two wavefronts a warp, the minimum), wait, and hand
// the stage back by a second mbarrier.
template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_gemm_tma_kernel(GemmArgs a, const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb) {
  constexpr int MT = BM / 128, kATile = BM * TK;
  constexpr int ST = tma_stages<BM>(), kTmaStage = tma_stage<BM>();
  static_assert(BM * kLdo * 4 <= 2 * kWTile + ST * kTmaStage, "staging");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  __shared__ int is_last;
  unsigned char* const smem =
      smem_raw + ((1024 - (lbt_smem(smem_raw) & 1023)) & 1023);
  int8_t* const Bt = reinterpret_cast<int8_t*>(smem);
  int8_t* const ring = Bt + 2 * kWTile;
  float* const wsc = reinterpret_cast<float*>(ring + ST * kTmaStage);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int M = a.M, N = a.N;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * BM;
  const int kt = (a.K + TK - 1) / TK, S = gridDim.z;
  const int t0 = (int)((long)kt * blockIdx.z / S);
  const int nt = (int)((long)kt * (blockIdx.z + 1) / S) - t0;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int acc[MT][16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
  if (warp == 8) {
    if (lane < TN / 4) {
      const int n = n0 + 4 * lane;
      lbt_cp16(wsc + 4 * lane, a.ws + (n < N ? n : 0), n < N);
    }
    lbt_cp_commit();
    if (lane == 0) {
      // the weights of the first stages before the quant pass has ended,
      // the codes after
      for (int i = 0; i < ST && i < nt; ++i) {
        mbar_expect(&full[i], kTmaStage);
        tma_3d(ring + i * kTmaStage + kATile, &tb, n0, (t0 + i) * (TK / 8), 0,
               &full[i]);
      }
      griddep_wait();
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST;
        if (t >= ST) {
          mbar_wait(&empty[s], ((t / ST) - 1) & 1);
          mbar_expect(&full[s], kTmaStage);
          tma_3d(ring + s * kTmaStage + kATile, &tb, n0, (t0 + t) * (TK / 8),
                 0, &full[s]);
        }
        tma_2d(ring + s * kTmaStage, &ta, (t0 + t) * TK, m0, &full[s]);
      }
    }
    lbt_cp_wait<0>();
  } else {
    const int kb = lane & 15, nb = 2 * warp + (lane >> 4);
    // raw weights of stage i ([kk][kg][n], chunk c of row kk * 16 + kg at
    // c ^ (kg & 7)) -> Bt[b] ([n][k], chunk c of row n at c ^ (n & 7))
    auto transpose = [&](int i, int b) {
      const int8_t* src = ring + i * kTmaStage + kATile + kb * TN +
                          ((((nb >> 1) ^ kb) & 7) << 4) + (nb & 1) * 8;
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint2 v =
            *reinterpret_cast<const uint2*>(src + r * (TK / 8) * TN);
        lo[r] = v.x;
        hi[r] = v.y;
      }
      uint32_t c[4][4];
      transpose4(lo[0], lo[1], lo[2], lo[3], c[0]);
      transpose4(lo[4], lo[5], lo[6], lo[7], c[1]);
      transpose4(hi[0], hi[1], hi[2], hi[3], c[2]);
      transpose4(hi[4], hi[5], hi[6], hi[7], c[3]);
      int8_t* dst = Bt + b * kWTile + nb * 8 * TK + (kb & 1) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = j < 4 ? 0 : 2;
        *reinterpret_cast<uint2*>(dst + j * TK +
                                  ((((kb >> 1) ^ j) & 7) << 4)) =
            make_uint2(c[q][j & 3], c[q + 1][j & 3]);
      }
    };
    auto products = [&](int i, int b) {
      const uint32_t a0 =
          lbt_smem(ring + i * kTmaStage) + (warp >> 2) * (BM / 2) * TK;
      const uint32_t b0 = lbt_smem(Bt + b * kWTile);
      lbt_wg_fence();
#pragma unroll
      for (int ks = 0; ks < TK / 32; ++ks)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_s8_128(acc[mt],
                       lbt_wg_desc(a0 + mt * 64 * TK + ks * 32, 16, 1024),
                       lbt_wg_desc(b0 + ks * 32, 16, 1024));
      lbt_wg_commit();
    };
    if (nt > 0) {
      mbar_wait(&full[0], 0);
      transpose(0, 0);
      lbt_fence_proxy_async();
    }
    consumers_sync();
    // iteration it: tile it's products, tile it + 1's pass beside them;
    // after the barrier Bt[(it + 1) & 1] is whole, Bt[it & 1] free, and
    // stage it % ST goes back to the producer
    for (int it = 0; it < nt; ++it) {
      products(it % ST, it & 1);
      if (it + 1 < nt) {
        mbar_wait(&full[(it + 1) % ST], ((it + 1) / ST) & 1);
        transpose((it + 1) % ST, (it + 1) & 1);
        lbt_fence_proxy_async();
      }
      lbt_wg_wait0();
      consumers_sync();
      if (tid == 0) mbar_arrive(&empty[it % ST]);
    }
  }
  griddep_wait();
  __syncthreads();

  // the sums through shared memory, then the epilogue by all threads
  int* const stg = reinterpret_cast<int*>(smem);
  if (warp < 8) {
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int rb = (warp >> 2) * (BM / 2) + mt * 64 + (warp & 3) * 16 + g;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<int2*>(stg + (rb + 8 * h) * kLdo + j * 8 +
                                   2 * tig) =
              make_int2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
    }
  }
  __syncthreads();
  constexpr int kQuads = BM * TN / 4;
  if (S == 1) {
    for (int u = tid; u < kQuads; u += kThreads) {
      const int r = u >> 5, c = (u & 31) * 4;
      if (m0 + r >= M || n0 + c >= N) continue;
      put4(a, (long)(m0 + r) * N + n0 + c,
           *reinterpret_cast<const int4*>(stg + r * kLdo + c),
           __ldcg(a.xs + m0 + r), *reinterpret_cast<const float4*>(wsc + c));
    }
    return;
  }
  const long MN = (long)M * N;
  for (int u = tid; u < kQuads; u += kThreads) {
    const int r = u >> 5, c = (u & 31) * 4;
    if (m0 + r >= M || n0 + c >= N) continue;
    *reinterpret_cast<int4*>(a.part + blockIdx.z * MN + (long)(m0 + r) * N +
                             n0 + c) =
        *reinterpret_cast<const int4*>(stg + r * kLdo + c);
  }
  if (!last_of_split(a, is_last)) return;
  for (int u = tid; u < kQuads; u += kThreads) {
    const int r = u >> 5, c = (u & 31) * 4;
    if (m0 + r >= M || n0 + c >= N) continue;
    const long off = (long)(m0 + r) * N + n0 + c;
    int4 v = make_int4(0, 0, 0, 0);
    for (int q = 0; q < S; ++q) {
      const int4 p = __ldcg(reinterpret_cast<const int4*>(a.part + q * MN + off));
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    put4(a, off, v, __ldcg(a.xs + m0 + r),
         *reinterpret_cast<const float4*>(wsc + c));
  }
}

// -- at most 64 rows: mma.sync -------------------------------------------------------

constexpr int SBM = 64, SBN = 64, SBK = 64, SLD = SBK + 16;
constexpr int kSmallThreads = 128;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// out[off], out[off + 1] from two sums, as put4
__device__ __forceinline__ void put2(const GemmArgs& a, long off, int v0,
                                     int v1, float s, float w0, float w1) {
  const float f0 = __fmul_rn(__fmul_rn((float)v0, s), w0);
  const float f1 = __fmul_rn(__fmul_rn((float)v1, s), w1);
  if (a.out_bf16)
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + off) =
        lbt_pack_bf16(f0, f1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(a.out) + off) =
        make_float2(f0, f1);
}

// 64 x 64 tiles, 4 warps of 32 x 32, K in steps of 64, split blockIdx.z of
// gridDim.z: each thread loads 4 weight rows x 4 columns and transposes
// them in registers into the k-major tile; shared rows padded to 80 bytes
// so the fragment loads hit 32 banks
__global__ void __launch_bounds__(kSmallThreads) w8a8_gemm_small_kernel(
    GemmArgs a) {
  __shared__ __align__(16) int8_t As[SBM][SLD];   // [m][k]
  __shared__ __align__(16) int8_t Bs[SBN][SLD];   // [n][k]
  __shared__ int is_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  const int M = a.M, K = a.K, Kp = a.Kp, N = a.N;
  const int kt = (Kp + SBK - 1) / SBK, S = gridDim.z;
  const int k_lo = (int)((long)kt * blockIdx.z / S) * SBK;
  const int k_hi = (int)((long)kt * (blockIdx.z + 1) / S) * SBK;
  griddep_wait();
  int acc[2][4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += SBK) {
    for (int i = tid; i < SBM * (SBK / 16); i += kSmallThreads) {
      const int row = i >> 2, kc = (i & 3) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < M && k0 + kc < Kp)
        v = *reinterpret_cast<const uint4*>(a.xq + (long)(m0 + row) * Kp + k0 +
                                            kc);
      *reinterpret_cast<uint4*>(&As[row][kc]) = v;
    }
    for (int i = tid; i < (SBK / 4) * (SBN / 4); i += kSmallThreads) {
      const int ng = i & 15, kq = i >> 4;
      const int k = k0 + kq * 4, n = n0 + ng * 4;
      uint32_t r[4] = {0u, 0u, 0u, 0u};
      if (n < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K)
            r[j] = __ldg(reinterpret_cast<const uint32_t*>(
                a.w + (long)(k + j) * N + n));
      }
      uint32_t c[4];
      transpose4(r[0], r[1], r[2], r[3], c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(&Bs[ng * 4 + j][kq * 4]) = c[j];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; kk += 32) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        af[mt][0] = lds32(&As[r][kk + tig * 4]);
        af[mt][1] = lds32(&As[r + 8][kk + tig * 4]);
        af[mt][2] = lds32(&As[r][kk + 16 + tig * 4]);
        af[mt][3] = lds32(&As[r + 8][kk + 16 + tig * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g;
        bfr[nt][0] = lds32(&Bs[c][kk + tig * 4]);
        bfr[nt][1] = lds32(&Bs[c][kk + 16 + tig * 4]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bfr[nt]);
    }
    __syncthreads();
  }
  // accumulator fragment: c0, c1 at row g, columns 2*tig, 2*tig + 1; c2, c3
  // at row g + 8 (N % 4 == 0: c < N means c + 1 < N)
  const long MN = (long)M * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * 32 + mt * 16 + g + h * 8;
        const int c = n0 + wn * 32 + nt * 8 + tig * 2;
        if (r >= M || c >= N) continue;
        const long off = (long)r * N + c;
        if (S == 1)
          put2(a, off, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1],
               __ldcg(a.xs + r), a.ws[c], a.ws[c + 1]);
        else
          *reinterpret_cast<int2*>(a.part + blockIdx.z * MN + off) =
              make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  if (S == 1 || !last_of_split(a, is_last)) return;
  for (int u = tid; u < SBM * SBN / 2; u += kSmallThreads) {
    const int r = m0 + u / (SBN / 2), c = n0 + (u % (SBN / 2)) * 2;
    if (r >= M || c >= N) continue;
    const long off = (long)r * N + c;
    int2 v = make_int2(0, 0);
    for (int q = 0; q < S; ++q) {
      const int2 p = __ldcg(reinterpret_cast<const int2*>(a.part + q * MN + off));
      v.x += p.x;
      v.y += p.y;
    }
    put2(a, off, v.x, v.y, __ldcg(a.xs + r), a.ws[c], a.ws[c + 1]);
  }
}

// -- host side -------------------------------------------------------------------

// launch kern(args...) as a programmatic dependent of the previous kernel
// on st
template <typename Kern, typename... Args>
int launch_dependent(Kern kern, dim3 grid, int threads, size_t smem,
                     cudaStream_t st, const Args&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the TMA kernel's tensor maps: codes [M, Kp] in boxes of BM rows x 128 k;
// weights [K, N] as [8 kk][K / 8 kg][N] in boxes of 8 x 16 x 128; both
// with the 128-byte swizzle and zeros past the edges. Needs K % 8 == 0,
// N % 16 == 0 and 16-byte aligned weights
template <int BM>
int launch_tma(const GemmArgs& a, int splits, cudaStream_t st) {
  static_assert(tma_smem<BM>() <= (size_t)kMaxSmem, "shared memory");
  static unsigned done = 0;   // devices whose shared memory limit is raised
  EncodeTiled encode = encode_tiled();
  if (!encode) return LBT_UNSUPPORTED;
  CUtensorMap ta, tb;
  const cuuint64_t adim[2] = {(cuuint64_t)a.Kp, (cuuint64_t)a.M};
  const cuuint64_t astride[1] = {(cuuint64_t)a.Kp};
  const cuuint32_t abox[2] = {TK, BM}, ones[3] = {1, 1, 1};
  CUresult r = encode(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)a.xq, adim,
                      astride, abox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const cuuint64_t bdim[3] = {(cuuint64_t)a.N, (cuuint64_t)(a.K / 8), 8};
  const cuuint64_t bstride[2] = {(cuuint64_t)a.N * 8, (cuuint64_t)a.N};
  const cuuint32_t bbox[3] = {TN, TK / 8, 8};
  r = encode(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, (void*)a.w, bdim, bstride,
             bbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(done >> dev & 1u)) {
    e = cudaFuncSetAttribute(w8a8_gemm_tma_kernel<BM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tma_smem<BM>());
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) done |= 1u << dev;
  }
  const dim3 grid((a.N + TN - 1) / TN, (a.M + BM - 1) / BM, splits);
  return launch_dependent(w8a8_gemm_tma_kernel<BM>, grid, kThreads,
                          tma_smem<BM>(), st, a, ta, tb);
}

// the pass: 16-byte loads where the rows allow them
template <typename XT>
int launch_quant(const void* x, int M, int K, int Kp, void* xq, void* xs,
                 cudaStream_t st) {
  const bool vec = K % 8 == 0 && (unsigned long)x % 16 == 0;
  auto kern = vec ? quant_rows_kernel<XT, true> : quant_rows_kernel<XT, false>;
  kern<<<M, kQuantThreads, 0, st>>>((const XT*)x, K, Kp, (int8_t*)xq,
                                    (float*)xs);
  return (int)cudaGetLastError();
}

int quant(int x_dtype, const void* x, int M, int K, void* xq, void* xs,
          cudaStream_t st) {
  const int Kp = (K + 15) / 16 * 16;
  if (x_dtype == LBT_BF16) return launch_quant<bf16>(x, M, K, Kp, xq, xs, st);
  if (x_dtype == LBT_F32) return launch_quant<float>(x, M, K, Kp, xq, xs, st);
  return LBT_UNSUPPORTED;
}

}  // namespace

// x [M, K] (bf16 or f32, x_dtype as LbtDtype) -> xq [M, roundup(K, 16)]
// int8 codes (zero past K) and xs [M] f32: the row-quantize pass alone.
extern "C" int lbt_w8a8_quant_rows(int x_dtype, const void* x, void* xq,
                                   void* xs, int M, int K, void* stream) {
  if (M < 1 || K < 1) return LBT_UNSUPPORTED;
  return quant(x_dtype, x, M, K, xq, xs, (cudaStream_t)stream);
}

// x [M, K] (bf16 or f32, x_dtype as LbtDtype); w [K, N] int8, 4-byte
// aligned; ws [N] f32, 16-byte aligned; xq [M, roundup(K, 16)] int8 and xs
// [M] f32 scratch; out [M, N] f32, or bf16 when out_bf16, 16-byte aligned.
// bm 64: the mma.sync kernel (any shape); bm 128 or 256: the TMA kernel
// with bm-row tiles (K a multiple of 8, N of 16, w 16-byte aligned). When
// splits > 1: part int32 [splits, M, N] scratch and cnt, one unsigned int
// an output tile (bm x 64 or bm x 128) that is 0 before the call and is 0
// again after it. All contiguous on the device, N a multiple of 4, K *
// 127 * 127 < 2**31, 1 <= splits <= 8 and the in-dim's steps (64 with bm
// 64, else 128). Returns the first non-zero cudaGetLastError() of the two
// launches, a CUresult + 1000 where a tensor map is refused, or -1 for a
// configuration the kernels do not take.
extern "C" int lbt_w8a8_matmul(int x_dtype, const void* x, const void* w,
                               const void* ws, void* xq, void* xs, void* part,
                               void* cnt, void* out, int out_bf16, int M,
                               int K, int N, int bm, int splits,
                               void* stream) {
  if (M < 1 || K < 1 || N < 4 || N % 4) return LBT_UNSUPPORTED;
  if ((long)K * 127 * 127 >= (1L << 31)) return LBT_UNSUPPORTED;
  if (x_dtype != LBT_BF16 && x_dtype != LBT_F32) return LBT_UNSUPPORTED;
  if (bm != SBM && ((bm != 128 && bm != 256) || K % 8 || N % 16 ||
                    (unsigned long)w % 16))
    return LBT_UNSUPPORTED;
  const int Kp = (K + 15) / 16 * 16;
  const int steps = bm == SBM ? (Kp + SBK - 1) / SBK : (K + TK - 1) / TK;
  if (splits < 1 || splits > kMaxSplits || splits > steps ||
      (splits > 1 && (!part || !cnt)) || (M + bm - 1) / bm > 65535)
    return LBT_UNSUPPORTED;
  const GemmArgs a{(const int8_t*)xq, (const float*)xs, (const int8_t*)w,
                   (const float*)ws,  (int*)part,        (unsigned*)cnt,
                   out,               M,                 K,
                   Kp,                N,                 out_bf16 ? 1 : 0};
  cudaStream_t st = (cudaStream_t)stream;
  const int e = quant(x_dtype, x, M, K, xq, xs, st);
  if (e != 0) return e;
  if (bm == 256) return launch_tma<256>(a, splits, st);
  if (bm == 128) return launch_tma<128>(a, splits, st);
  const dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM, splits);
  return launch_dependent(w8a8_gemm_small_kernel, grid, kSmallThreads, 0, st,
                          a);
}
