// The post-attention layer tail in three kernels launched back to back:
//   A: int8(attn_out) . wo -> bf16 -> xnew = bf16(x_res + bf16(attn_out*rs))
//   B: rms_norm(xnew) -> int8 -> gate|up -> bf16 -> act = bf16(act(g) * u)
//   C: int8(act) . down -> bf16 -> out = bf16(xnew + bf16(ffn_out * rs))
//
// Replaces the Pallas kernel _tail_kernel / fused_layer_tail
// (llama_box_tpu/ops/fused_decode.py:115, :190). The TPU kernel is one
// sequential phased grid that carries xnew and act in VMEM from phase to
// phase. CUDA blocks run in no order and cannot carry anything between
// them, and each per-row int8 quantization needs the whole row's max:
// after wo (of xnew, through the norm) and after gate|up (of act). So the
// tail is split at exactly those two points, with xnew [R, E] and act
// [R, FF] in bf16 scratch that the wrapper allocates; stream order makes
// each phase see the previous one's rows complete.
//
// What bounds it: bytes. wo, gate|up and down stream once (38.8 MB for a
// TinyLlama layer) for R <= 64 rows of multiply-adds per weight byte.
//
// Design: every phase is the row-tile dp4a GEMM of w8a8_common.cuh, one
// block of 256 threads per 32 output columns (phase B: 16 gate columns and
// the 16 up columns that pair with them, so the activation is formed in
// the epilogue). Each block recomputes the int8 codes (and in B the norm)
// of the rows it needs into shared memory. Every bf16 rounding of
// _tail_kernel is kept: attn_out, xnew, gate and up, act, and ffn_out
// before the residual; rs is rounded to bf16 as jnp.bfloat16(rs).
#include "w8a8_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace lbt_w8;

enum { kResid = 0, kGateUp = 1 };
enum { kSilu = 0, kGelu = 1, kRelu2 = 2 };

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

// x [R, K] rows -> codes (NORM: of rms_norm(x, nw)) . w, then the epilogue:
// kResid:  out[r, n] = bf16(res[r, n] + bf16(bf16(acc * xs * ws[n]) * rs)),
//          n < N, w [K, N];
// kGateUp: out[r, n] = bf16(act(g) * u), n < N (= FF), w [K, 2N] with the
//          gate column n and the up column N + n.
template <int MODE, bool NORM, typename NT>
__global__ void __launch_bounds__(kThreads) tail_phase_kernel(
    const bf16* __restrict__ x, int K, const NT* __restrict__ nw,
    float eps, const int8_t* __restrict__ w, const float* __restrict__ ws,
    int N, const bf16* __restrict__ res, float rs, int act,
    bf16* __restrict__ out, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + ((size_t)kRowGroup * K + 15) /
                                                   16 * 16);
  int* red = reinterpret_cast<int*>(xs + 16);
  const int cg = threadIdx.x % kColGroups, ks = threadIdx.x / kColGroups;
  // output columns of this block, and this thread's weight column
  constexpr int kOut = MODE == kGateUp ? kCols / 2 : kCols;
  const int n0 = blockIdx.x * kOut;
  int col, ldw;
  bool col_ok;
  if constexpr (MODE == kGateUp) {
    const int n = n0 + (cg % (kColGroups / 2)) * 4;
    col = (cg < kColGroups / 2 ? 0 : N) + n;
    col_ok = n < N;
    ldw = 2 * N;
  } else {
    col = n0 + cg * 4;
    col_ok = col < N;
    ldw = N;
  }
  const float rsb = lbt_round<bf16>(rs);
  for (int r0 = 0; r0 < R; r0 += kRowGroup) {
    const int rg = min(kRowGroup, R - r0);
    quant_rows<NORM, NT>(x, K, nw, eps, r0, rg, xq, xs);
    __syncthreads();
    int acc[kRowGroup][4] = {};
    dp4a_slice(xq, K, w, ldw, col, col_ok, ks, acc);
    reduce_slices(acc, red);
    for (int i = threadIdx.x; i < rg * kOut; i += kThreads) {
      const int r = i / kOut, c = i % kOut, n = n0 + c;
      if (n >= N) continue;
      const long o = (long)(r0 + r) * N + n;
      const int* sums = red + r * kCols;
      if constexpr (MODE == kGateUp) {
        const float g = lbt_round<bf16>((float)sums[c] * xs[r] * ws[n]);
        const float u =
            lbt_round<bf16>((float)sums[kOut + c] * xs[r] * ws[N + n]);
        out[o] = __float2bfloat16(act_f32(g, act) * u);
      } else {
        const float v = lbt_round<bf16>((float)sums[c] * xs[r] * ws[n]);
        out[o] = __float2bfloat16(lbt_f(res[o]) + lbt_round<bf16>(v * rsb));
      }
    }
    __syncthreads();   // the next pass rewrites xq, xs and red
  }
}

template <int MODE, bool NORM, typename NT = float>
int launch_phase(int blocks, const bf16* x, int K, const NT* nw, float eps,
                 const int8_t* w, const float* ws, int N, const bf16* res,
                 float rs, int act, bf16* out, int R, cudaStream_t st) {
  const size_t smem = smem_bytes(K);
  if (smem > 227 * 1024) return LBT_UNSUPPORTED;
  cudaError_t e = cudaFuncSetAttribute(
      tail_phase_kernel<MODE, NORM, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  tail_phase_kernel<MODE, NORM, NT><<<blocks, kThreads, smem, st>>>(
      x, K, nw, eps, w, ws, N, res, rs, act, out, R);
  return (int)cudaGetLastError();
}

template <typename NT>
int launch_tail(const void* ao, const void* xres, const void* wo,
                const void* wo_sc, const void* nw, const void* gu,
                const void* gu_sc, const void* dn, const void* dn_sc,
                void* xnew, void* act, void* out, int R, int HD, int E,
                int FF, float eps, float rs, int act_fn, cudaStream_t st) {
  const int e_blocks = (E + kCols - 1) / kCols;
  const int ff_blocks = (FF + kCols / 2 - 1) / (kCols / 2);
  int rc = launch_phase<kResid, false>(
      e_blocks, (const bf16*)ao, HD, (const float*)nullptr, 0.f,
      (const int8_t*)wo, (const float*)wo_sc, E, (const bf16*)xres, rs,
      act_fn, (bf16*)xnew, R, st);
  if (rc) return rc;
  rc = launch_phase<kGateUp, true, NT>(
      ff_blocks, (const bf16*)xnew, E, (const NT*)nw, eps, (const int8_t*)gu,
      (const float*)gu_sc, FF, nullptr, rs, act_fn, (bf16*)act, R, st);
  if (rc) return rc;
  return launch_phase<kResid, false>(
      e_blocks, (const bf16*)act, FF, (const float*)nullptr, 0.f,
      (const int8_t*)dn, (const float*)dn_sc, E, (const bf16*)xnew, rs,
      act_fn, (bf16*)out, R, st);
}

}  // namespace

// ao [R, HD] bf16; xres [R, E] bf16; wo [HD, E], gu [E, 2*FF] (gate columns
// first), dn [FF, E] int8 with f32 column scales; nw [E] bf16 or f32
// (nw_dtype as LbtDtype); xnew [R, E] and act [R, FF] bf16 scratch; out
// [R, E] bf16. act_fn: 0 silu, 1 gelu (tanh), 2 relu2. All contiguous on
// the device, every width a multiple of 4, the weights 4-byte aligned.
// Returns the first non-zero cudaGetLastError() of the three launches, or
// -1 for a configuration the kernels do not take.
extern "C" int lbt_fused_layer_tail(
    int nw_dtype, const void* ao, const void* xres, const void* wo,
    const void* wo_sc, const void* nw, const void* gu, const void* gu_sc,
    const void* dn, const void* dn_sc, void* xnew, void* act, void* out,
    int R, int HD, int E, int FF, float eps, float rs, int act_fn,
    void* stream) {
  if (R < 1 || HD % 4 || E % 4 || FF % 4 || HD < 4 || E < 4 || FF < 4 ||
      act_fn < kSilu || act_fn > kRelu2)
    return LBT_UNSUPPORTED;
  cudaStream_t st = (cudaStream_t)stream;
#define LBT_TAIL_ARGS                                                      \
  ao, xres, wo, wo_sc, nw, gu, gu_sc, dn, dn_sc, xnew, act, out, R, HD, E, \
      FF, eps, rs, act_fn, st
  if (nw_dtype == LBT_BF16) return launch_tail<bf16>(LBT_TAIL_ARGS);
  if (nw_dtype == LBT_F32) return launch_tail<float>(LBT_TAIL_ARGS);
#undef LBT_TAIL_ARGS
  return LBT_UNSUPPORTED;
}
