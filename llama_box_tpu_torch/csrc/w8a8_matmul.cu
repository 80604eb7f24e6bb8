// The w8a8 matmul: per-row int8 activations, s8 x s8 -> s32 against
// per-column int8 weights, then float(acc) * xs * ws (f32 output; mm()
// casts it to the activations' dtype).
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
// Design: two kernels launched back to back. The first quantizes each row
// (one block per row: max, then codes with IEEE division and rintf, so the
// codes equal torch.round(x / xs) bit for bit) into an int8 [M, Kp] buffer
// padded with zero codes to a multiple of 16 bytes. The second is a plain
// tensor-core GEMM: 64 x 64 output tiles, 4 warps of 32 x 32, K in steps of
// 64, mma.sync.m16n8k32 s8.s8.s32. Both mma operands must hold consecutive
// k in a register; the weights stay [in, out] as in the JAX layout (k is
// `out` bytes apart), so each thread loads 4 rows x 4 columns and
// transposes them in registers (__byte_perm) into the k-major shared tile.
// Shared rows are padded to 80 bytes so the fragment loads hit 32 banks.
// The integer sum is exact, so the result equals the plain version's bit
// for bit. No cp.async pipelining, no wgmma: a later PR's work.
#include "w8a8_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace lbt_w8;

constexpr int BM = 64, BN = 64, BK = 64, LDS = BK + 16;
constexpr int kGemmThreads = 128;
constexpr int kQuantThreads = 256;

template <typename XT>
__global__ void __launch_bounds__(kQuantThreads) quant_rows_kernel(
    const XT* __restrict__ x, int K, int Kp, int8_t* __restrict__ xq,
    float* __restrict__ xs) {
  __shared__ float part[kQuantThreads / 32];
  const long m = blockIdx.x;
  const XT* row = x + m * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    amax = nanmax(amax, fabsf(lbt_f(row[k])));
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = part[0];
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = nanmax(amax, part[w]);
  const float s = row_scale(amax);
  for (int k = threadIdx.x; k < Kp; k += kQuantThreads)
    xq[m * Kp + k] = k < K ? code(lbt_f(row[k]), s) : (int8_t)0;
  if (threadIdx.x == 0) xs[m] = s;
}

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

// out [M, N] f32 = float(xq [M, Kp] . w [K, N]) * xs[m] * ws[n]
__global__ void __launch_bounds__(kGemmThreads) w8a8_gemm_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const int8_t* __restrict__ w, const float* __restrict__ ws,
    float* __restrict__ out, int M, int K, int Kp, int N) {
  __shared__ __align__(16) int8_t As[BM][LDS];   // [m][k]
  __shared__ __align__(16) int8_t Bs[BN][LDS];   // [n][k]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[2][4][4] = {};
  for (int k0 = 0; k0 < Kp; k0 += BK) {
    // A: 64 rows x 4 chunks of 16 codes
    for (int i = tid; i < BM * (BK / 16); i += kGemmThreads) {
      const int row = i >> 2, kc = (i & 3) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < M && k0 + kc < Kp)
        v = *reinterpret_cast<const uint4*>(xq + (long)(m0 + row) * Kp + k0 +
                                            kc);
      *reinterpret_cast<uint4*>(&As[row][kc]) = v;
    }
    // B: 16 k-quads x 16 column groups of 4, transposed to [n][k]
    for (int i = tid; i < (BK / 4) * (BN / 4); i += kGemmThreads) {
      const int ng = i & 15, kq = i >> 4;
      const int k = k0 + kq * 4, n = n0 + ng * 4;
      uint32_t r[4] = {0u, 0u, 0u, 0u};
      if (n < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K)
            r[j] = __ldg(reinterpret_cast<const uint32_t*>(
                w + (long)(k + j) * N + n));
      }
      uint32_t c[4];
      transpose4(r[0], r[1], r[2], r[3], c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(&Bs[ng * 4 + j][kq * 4]) = c[j];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        a[mt][0] = lds32(&As[r][kk + tig * 4]);
        a[mt][1] = lds32(&As[r + 8][kk + tig * 4]);
        a[mt][2] = lds32(&As[r][kk + 16 + tig * 4]);
        a[mt][3] = lds32(&As[r + 8][kk + 16 + tig * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + g;
        b[nt][0] = lds32(&Bs[c][kk + tig * 4]);
        b[nt][1] = lds32(&Bs[c][kk + 16 + tig * 4]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }
  // accumulator fragment: c0, c1 at row g, columns 2*tig, 2*tig + 1;
  // c2, c3 at row g + 8
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * 32 + mt * 16 + g + h * 8;
        if (r >= M) continue;
        const float s = xs[r];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n0 + wn * 32 + nt * 8 + tig * 2 + j;
          if (c < N)
            out[(long)r * N + c] = (float)acc[mt][nt][h * 2 + j] * s * ws[c];
        }
      }
}

template <typename XT>
int launch(const void* x, const void* w, const void* ws, void* xq, void* xs,
           void* out, int M, int K, int N, cudaStream_t st) {
  const int Kp = (K + 15) / 16 * 16;
  quant_rows_kernel<XT><<<M, kQuantThreads, 0, st>>>(
      (const XT*)x, K, Kp, (int8_t*)xq, (float*)xs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w8a8_gemm_kernel<<<grid, kGemmThreads, 0, st>>>(
      (const int8_t*)xq, (const float*)xs, (const int8_t*)w,
      (const float*)ws, (float*)out, M, K, Kp, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (bf16 or f32, x_dtype as LbtDtype); w [K, N] int8, 4-byte
// aligned; ws [N] f32; xq [M, roundup(K, 16)] int8 and xs [M] f32 scratch;
// out [M, N] f32. All contiguous on the device, N a multiple of 4,
// K * 127 * 127 < 2**31. Returns the first non-zero cudaGetLastError() of
// the two launches, or -1 for a configuration the kernels do not take.
extern "C" int lbt_w8a8_matmul(int x_dtype, const void* x, const void* w,
                               const void* ws, void* xq, void* xs, void* out,
                               int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 4 || N % 4) return LBT_UNSUPPORTED;
  if (M > 65535 * BM) return LBT_UNSUPPORTED;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == LBT_BF16)
    return launch<bf16>(x, w, ws, xq, xs, out, M, K, N, st);
  if (x_dtype == LBT_F32)
    return launch<float>(x, w, ws, xq, xs, out, M, K, N, st);
  return LBT_UNSUPPORTED;
}
