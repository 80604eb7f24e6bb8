// Row norms over the last dimension: RMSNorm, and LayerNorm with an
// optional bias.
//
// Replaces no Pallas kernel: the JAX package's norms (ops/norm.rms_norm,
// models/llama._norm_any and _ln_per_head, models/bert._ln) are plain jnp
// that XLA fuses. In the port they were about seven torch ops each, and
// torch's mean takes its sum in an order that follows the number of rows,
// so one row normed inside a 36-row verify pass could round differently
// from the same row normed alone in a one-row decode step. This kernel
// sums every row in one order that depends on the row length n alone.
//
// Rounding points (JAX ops/norm.rms_norm, models/llama._norm_any): the
// input widened to f32; RMS: var = sum(x^2) / n, y = (x * inv) * w; LN:
// mu = sum(x) / n, var = sum((x - mu)^2) / n, y = ((x - mu) * inv) * w
// (+ b); inv = 1 / sqrtf(var + eps) (IEEE sqrt and division, as
// w8a8_common.cuh's row_stats); one rounding to the input's dtype.
//
// What bounds it: bytes. Each row is read once for each statistic (from
// L1 or L2 after the first pass) and written once; a few flops an element.
//
// Layout: TPR threads a row (32 below 1024 elements, else 256; a block of
// 256 threads holds 256 / TPR rows). Thread t of a row takes the chunks
// t, t + TPR, t + 2 TPR, ... of VEC consecutive elements (VEC 8 when n is
// a multiple of 8, else 1) and adds them in element order; the TPR
// partial sums meet in a fixed xor-shuffle tree inside each warp, then the
// warps' sums in warp order. TPR and VEC are functions of n, so a row's
// bits depend on its values, n and its weight row alone: not on the
// number of rows, the row's index or the grid.
//
// The weight (and bias) is [G, n]: row r takes row r mod G (G = 1: one
// weight for every row; G = H: chameleon's per-head LayerNorm over rows of
// D laid out [..., H, D]).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

// VEC elements from p (16-byte aligned when VEC == 8) widened to f32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 8 && std::is_same<T, bf16>::value) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
  } else if constexpr (VEC == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = lbt_f(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8 && std::is_same<T, bf16>::value) {
    uint4 u;
    u.x = lbt_pack_bf16(v[0], v[1]);
    u.y = lbt_pack_bf16(v[2], v[3]);
    u.z = lbt_pack_bf16(v[4], v[5]);
    u.w = lbt_pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = u;
  } else if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = lbt_from_f<T>(v[j]);
  }
}

// the sum of every thread's s over the TPR threads of a row, the same
// value in each of them; red holds a slot for each warp of the block
template <int TPR>
__device__ __forceinline__ float row_sum(float s, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if constexpr (TPR == 32) {
    return s;
  } else {
    static_assert(TPR == kThreads, "a row is one warp or the whole block");
    const int warp = threadIdx.x >> 5;
    __syncthreads();   // red's previous use is read by every thread
    if ((threadIdx.x & 31) == 0) red[warp] = s;
    __syncthreads();
    float t = red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) t += red[w];
    return t;
  }
}

template <typename T, typename W, bool LN, int TPR, int VEC>
__global__ void __launch_bounds__(kThreads)
    norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                const W* __restrict__ b, T* __restrict__ out, long rows,
                int n, int G, float eps) {
  __shared__ float red[kThreads / 32];
  constexpr int kRowsPerBlock = kThreads / TPR;
  const long r = (long)blockIdx.x * kRowsPerBlock + threadIdx.x / TPR;
  // whole rows (a warp, or the block) leave together: the shuffles and
  // barriers of row_sum see every thread of their row
  if (r >= rows) return;
  const int t = threadIdx.x % TPR;
  const int chunks = n / VEC;
  const T* xr = x + r * n;
  const long wo = (r % G) * (long)n;

  float s = 0.f;
  for (int c = t; c < chunks; c += TPR) {
    float v[VEC];
    load_vec<T, VEC>(xr + c * VEC, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) s += LN ? v[j] : v[j] * v[j];
  }
  s = row_sum<TPR>(s, red);
  float mu = 0.f, var;
  if constexpr (LN) {
    mu = s / (float)n;
    float s2 = 0.f;
    for (int c = t; c < chunks; c += TPR) {
      float v[VEC];
      load_vec<T, VEC>(xr + c * VEC, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[j] - mu;
        s2 += d * d;
      }
    }
    var = row_sum<TPR>(s2, red) / (float)n;
  } else {
    var = s / (float)n;
  }
  const float inv = 1.0f / sqrtf(var + eps);

  for (int c = t; c < chunks; c += TPR) {
    float v[VEC];
    load_vec<T, VEC>(xr + c * VEC, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const long i = wo + c * VEC + j;
      float y = (LN ? (v[j] - mu) : v[j]) * inv;
      y = y * lbt_f(w[i]);
      if (LN && b != nullptr) y = y + lbt_f(b[i]);
      v[j] = y;
    }
    store_vec<T, VEC>(out + r * n + c * VEC, v);
  }
}

template <typename T, typename W, bool LN>
int launch(const void* x, const void* w, const void* b, void* out,
           long rows, int n, int G, float eps, cudaStream_t st) {
  const bool vec = n % 8 == 0;
  const bool wide = n >= 1024;
  const int per_block = wide ? 1 : kThreads / 32;
  const dim3 grid((unsigned)((rows + per_block - 1) / per_block));
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>((const T*)x, (const W*)w,
                                      (const W*)b, (T*)out, rows, n, G, eps);
  };
  if (wide && vec) args(norm_kernel<T, W, LN, kThreads, 8>);
  else if (wide) args(norm_kernel<T, W, LN, kThreads, 1>);
  else if (vec) args(norm_kernel<T, W, LN, 32, 8>);
  else args(norm_kernel<T, W, LN, 32, 1>);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int by_style(int ln, const void* x, const void* w, const void* b, void* out,
             long rows, int n, int G, float eps, cudaStream_t st) {
  if (ln) return launch<T, W, true>(x, w, b, out, rows, n, G, eps, st);
  return launch<T, W, false>(x, w, b, out, rows, n, G, eps, st);
}

}  // namespace

// x, out [rows, n] of x_dtype (bf16 or f32; with n a multiple of 8, both
// 16-byte aligned); w [G, n] of w_dtype (bf16 or f32); b null, or [G, n] of
// w_dtype (LayerNorm only). ln: 0 RMSNorm, 1 LayerNorm. All contiguous on
// the device; rows >= 0, n >= 1, G >= 1. Returns cudaGetLastError() after
// the launch, or -1 for a configuration the kernel does not take.
extern "C" int lbt_norm(int x_dtype, int w_dtype, int ln, const void* x,
                        const void* w, const void* b, void* out, int rows, int n,
                        int G, float eps, void* stream) {
  if (rows < 0 || n < 1 || G < 1) return LBT_UNSUPPORTED;
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == LBT_BF16 && w_dtype == LBT_BF16)
    return by_style<bf16, bf16>(ln, x, w, b, out, rows, n, G, eps, st);
  if (x_dtype == LBT_BF16 && w_dtype == LBT_F32)
    return by_style<bf16, float>(ln, x, w, b, out, rows, n, G, eps, st);
  if (x_dtype == LBT_F32 && w_dtype == LBT_BF16)
    return by_style<float, bf16>(ln, x, w, b, out, rows, n, G, eps, st);
  if (x_dtype == LBT_F32 && w_dtype == LBT_F32)
    return by_style<float, float>(ln, x, w, b, out, rows, n, G, eps, st);
  return LBT_UNSUPPORTED;
}
