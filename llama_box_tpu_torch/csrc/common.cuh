// Shared helpers for the attention kernels (flash_prefill.cu, flash_decode.cu)
// and the tensor-core kernels' copy and fragment instructions (cp.async,
// ldmatrix; flash_prefill.cu, flash_decode.cu, q_matmul.cu).
//
// Element types: the attention compute dtype QT is float or __nv_bfloat16
// (the JAX model's `adt`); the KV cache holds QT, or int8 codes with one
// scale per (position, head) of type ST (bf16 or f32). A dequantized cache
// element is rounded to QT, the same rounding point as the Pallas kernels'
// `.astype(qdt)`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define LBT_NEG_INF (-1e30f)

// dtype codes passed from Python (ops/_kernels.py DTYPE_CODES)
enum LbtDtype { LBT_F32 = 0, LBT_BF16 = 1, LBT_I8 = 2 };

// error returned for a configuration no instantiation covers
#define LBT_UNSUPPORTED (-1)

__device__ __forceinline__ float lbt_f(float x) { return x; }
__device__ __forceinline__ float lbt_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float lbt_f(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T lbt_from_f(float x);
template <>
__device__ __forceinline__ float lbt_from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 lbt_from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round a float through QT (identity for f32)
template <typename QT>
__device__ __forceinline__ float lbt_round(float x) {
  return lbt_f(lbt_from_f<QT>(x));
}

// one cache element as the kernel sees it: QT as stored, or int8 times its
// per-(position, head) scale, rounded to QT
template <typename QT, typename CT, typename ST>
__device__ __forceinline__ float lbt_kv(const CT* __restrict__ x,
                                        const ST* __restrict__ s, long idx,
                                        long sidx) {
  if constexpr (std::is_same<CT, int8_t>::value) {
    return lbt_round<QT>((float)x[idx] * lbt_f(s[sidx]));
  } else {
    return lbt_f(x[idx]);
  }
}

// the position mask both kernels share: causal, sliding window, aligned
// chunk (all relative to the query position qpos)
__device__ __forceinline__ bool lbt_pos_ok(int kpos, int qpos, int window,
                                           int chunk) {
  bool ok = kpos <= qpos;
  ok = ok && (window <= 0 || kpos > qpos - window);
  ok = ok && (chunk <= 0 || kpos / chunk == qpos / chunk);
  return ok;
}

// One key of the streaming softmax (flash_prefill.cu), processed strictly
// in key order. The running max is raised (and the sums rescaled) only when
// a score exceeds it, so the result depends on the sequence of keys alone
// and not on how they were cut into tiles: a key read from the cache and
// the same key read from the rows operand give bit-identical outputs.
// flash_decode.cu's f32 kernel computes the same fold with the
// exponentials taken in parallel. p is rounded to QT before it weights V, as the Pallas kernels
// do.
template <typename QT, int N>
__device__ __forceinline__ float lbt_softmax_step(float s, float& m, float& l,
                                                  float (&acc)[N]) {
  if (s > m) {
    const float alpha = expf(m - s);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] *= alpha;
    m = s;
  }
  const float p = expf(s - m);
  l += p;
  return lbt_round<QT>(p);
}

// -- tensor cores: mma.sync, cp.async (sm_80+) and ldmatrix ------------------

// c += a . b, m16n8k16, bf16 x bf16 -> f32
__device__ __forceinline__ void lbt_mma_bf16(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats as two bf16 (round to nearest even), lo in the low half: one
// paired conversion (conversions issue at a quarter of the FMA rate)
__device__ __forceinline__ uint32_t lbt_pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// byte j (0..3) of w as an exact float, without a conversion instruction:
// the byte becomes the low mantissa bits of 2^23, which is then subtracted
// (for int8 codes w holds the bytes ^ 0x80 and bias is 2^23 + 128)
__device__ __forceinline__ float lbt_byte_f(uint32_t w, int j, float bias) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | j)),
                   bias);
}
constexpr float LBT_U8_BIAS = 8388608.f, LBT_S8_BIAS = 8388736.f;

// 8 int8 cache codes times their scale, each rounded to bf16 (kv_dequant)
template <typename ST>
__device__ __forceinline__ uint4 lbt_deq8(const int8_t* p, ST sc) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
  const float s = lbt_f(sc);
  auto c = [&](int j) {
    return __fmul_rn(lbt_byte_f(w[j >> 2], j & 3, LBT_S8_BIAS), s);
  };
  return make_uint4(lbt_pack_bf16(c(0), c(1)), lbt_pack_bf16(c(2), c(3)),
                    lbt_pack_bf16(c(4), c(5)), lbt_pack_bf16(c(6), c(7)));
}

__device__ __forceinline__ uint32_t lbt_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !ok (src is not
// read then, but must still be a valid address)
__device__ __forceinline__ void lbt_cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   lbt_smem(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 8 bytes global -> shared (through L1), zero-filled when !ok
__device__ __forceinline__ void lbt_cp8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   lbt_smem(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void lbt_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void lbt_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, register i receives matrix i's fragment (thread t:
// row t/4, columns 2(t%4) and 2(t%4)+1; transposed with _t)
__device__ __forceinline__ void lbt_ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(lbt_smem(p))
      : "memory");
}
__device__ __forceinline__ void lbt_ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(lbt_smem(p))
      : "memory");
}
