// Fused rms_norm -> per-row int8 -> s8 x s8 -> s32 -> rescale -> bf16.
//
// Replaces the Pallas kernel _norm_qmm_kernel / fused_norm_qmm
// (llama_box_tpu/ops/fused_decode.py:67, :76): the fused q/k/v projection
// and the output (vocab) projection at decode widths, R <= 64 rows.
//
// What bounds it: bytes. The weights [E, O] int8 stream once (5.2 MB for
// TinyLlama's wqkv, 65.5 MB for its 32000-wide output) and each weight
// byte feeds R multiply-adds, far below the card's int8 ridge. The TPU
// kernel tiled the output columns and kept the R rows resident in VMEM.
//
// Design: one block of 256 threads per 32 output columns. Each block
// recomputes the norm and the int8 codes of its rows into shared memory
// (at R = 4, E = 2048 that is 16 KB of reads from L2, cheaper than a
// second launch and a round trip through device memory), then streams its
// [E, 32] weight columns once: 32 k-slices of dp4a over in-register
// transposed weight words (w8a8_common.cuh), summed in a fixed order.
// Rows go in passes of 8 (the weights of a pass come from L2 after the
// first). The epilogue is float(acc) * xs * scale, rounded to bf16.
#include "w8a8_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace lbt_w8;

template <typename NT>
__global__ void __launch_bounds__(kThreads) norm_qmm_kernel(
    const bf16* __restrict__ x, const NT* __restrict__ nw,
    const int8_t* __restrict__ w, const float* __restrict__ ws,
    bf16* __restrict__ out, int R, int E, int O, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + ((size_t)kRowGroup * E + 15) /
                                                   16 * 16);
  int* red = reinterpret_cast<int*>(xs + 16);
  const int cg = threadIdx.x % kColGroups, ks = threadIdx.x / kColGroups;
  const int col = blockIdx.x * kCols + cg * 4;
  for (int r0 = 0; r0 < R; r0 += kRowGroup) {
    const int rg = min(kRowGroup, R - r0);
    quant_rows<true, NT>(x, E, nw, eps, r0, rg, xq, xs);
    __syncthreads();
    int acc[kRowGroup][4] = {};
    dp4a_slice(xq, E, w, O, col, col < O, ks, acc);
    reduce_slices(acc, red);
    for (int i = threadIdx.x; i < rg * kCols; i += kThreads) {
      const int r = i / kCols, c = blockIdx.x * kCols + i % kCols;
      if (c < O)
        out[(long)(r0 + r) * O + c] =
            __float2bfloat16((float)red[i] * xs[r] * ws[c]);
    }
    __syncthreads();   // the next pass rewrites xq, xs and red
  }
}

template <typename NT>
int launch(const void* x, const void* nw, const void* w, const void* ws,
           void* out, int R, int E, int O, float eps, cudaStream_t st) {
  const size_t smem = smem_bytes(E);
  if (smem > 227 * 1024) return LBT_UNSUPPORTED;
  cudaError_t e = cudaFuncSetAttribute(
      norm_qmm_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((O + kCols - 1) / kCols);
  norm_qmm_kernel<NT><<<grid, kThreads, smem, st>>>(
      (const bf16*)x, (const NT*)nw, (const int8_t*)w, (const float*)ws,
      (bf16*)out, R, E, O, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x [R, E] bf16; nw [E] bf16 or f32 (nw_dtype as LbtDtype); w [E, O]
// int8; ws [O] f32; out [R, O] bf16. All contiguous on the device, E and
// O multiples of 4, w 4-byte aligned. Returns cudaGetLastError() after
// the launch, or -1 for a configuration the kernel does not take.
extern "C" int lbt_fused_norm_qmm(int nw_dtype, const void* x,
                                  const void* nw, const void* w,
                                  const void* ws, void* out, int R, int E,
                                  int O, float eps, void* stream) {
  if (R < 1 || E < 4 || O < 4 || E % 4 || O % 4) return LBT_UNSUPPORTED;
  cudaStream_t st = (cudaStream_t)stream;
  if (nw_dtype == LBT_BF16)
    return launch<bf16>(x, nw, w, ws, out, R, E, O, eps, st);
  if (nw_dtype == LBT_F32)
    return launch<float>(x, nw, w, ws, out, R, E, O, eps, st);
  return LBT_UNSUPPORTED;
}
