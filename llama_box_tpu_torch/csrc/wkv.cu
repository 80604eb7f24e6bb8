// The matrix-state recurrences of the linear-attention mixers, one block a
// (slot, head), walking T rows with the [N, N] f32 state in registers (a
// column or a row of it a thread), updated in place. Three rules:
//
//   rwkv6 (mode 0; JAX models/rwkv._rwkv6_time_mix, _wkv6_scan): state
//     S[i, j] (i: key index, j: value index); thread j holds column j.
//       y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * (k_t[i] * v_t[j]))
//       S[i, j] = w_t[i] * S[i, j] + k_t[i] * v_t[j]
//   rwkv7 (mode 1; JAX _rwkv7_time_mix and _wkv7_scan): state S[i, l] (i:
//     value index, l: key index); thread i holds row i.
//       sa = sum_j S[i, j] * (-kk_t[j])
//       S[i, l] = S[i, l] * w_t[l] + sa * (kk_t[l] * a_t[l]) + v_t[i] * k_t[l]
//       y_t[i] = sum_l S[i, l] * r_t[l]
//   gated delta rule (mode 2; JAX models/mamba._mixer_deltanet): state
//     S[i, j] (i: key index, j: value index) of v-head h, whose q and k are
//     k-head h / (H / Hk)'s; thread j holds column j.
//       S[i, j] *= alpha_t;  kv = sum_i S[i, j] * k_t[i]
//       d = (v_t[j] - kv) * beta_t;  S[i, j] += k_t[i] * d
//       y_t[j] = sum_i S[i, j] * q_t[i]
// The update runs at rows t < seq_lens[s]; every row's output reads the
// state as it then stands (rwkv6's bonus term drops, its k v product zero,
// at a masked row, as JAX's masked contribution), and a slot with
// seq_lens 0 writes no state back.
//
// Replaces no Pallas kernel: the JAX package runs these as chunked
// associative scans over matrix pairs (rwkv) or a per-token lax.scan
// (DeltaNet), XLA ops both; llama.cpp's rwkv_wkv6 / rwkv_wkv7 ops are the
// model for this one. Each thread sums in a fixed order, the same at every
// T, so a prefill of P + Q rows equals a prefill of P then Q bit for bit,
// and a one-row decode step a one-row prefill.
//
// Inputs, f32, contiguous: per-step vectors [S, T, H, N] (mode 2: q, k [S,
// T, Hk, N], alpha, beta [S, T, H]); u [H, N] (mode 0); the state [S, H, N,
// N]; y [S, T, H, N]. N is 16, 32, 64 or 128.
//
// What bounds it: the T dependent steps of N^2 multiply-adds a head; the
// bytes are the state once a call and the vectors once a row.
#include "common.cuh"

namespace {

template <int N, int MODE>
__global__ void __launch_bounds__(N)
    wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ e, const float* __restrict__ f,
               const float* __restrict__ u, const int* __restrict__ seq_lens,
               float* __restrict__ state, float* __restrict__ y, int T, int H,
               int Hk) {
  __shared__ float sv[5][N];
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int j = threadIdx.x;
  const int L = seq_lens[s];
  const long sbase = ((long)s * H + h) * N * N;
  const int hk = MODE == 2 ? h / (H / Hk) : h;

  float st[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    st[i] = MODE == 1 ? state[sbase + (long)j * N + i]
                      : state[sbase + (long)i * N + j];
  // rwkv6's bonus u, read by key index: sv[4] holds it for the whole call
  if (MODE == 0) sv[4][j] = u[(long)h * N + j];

  for (int t = 0; t < T; ++t) {
    const long row = (long)s * T + t;
    const long vec = (row * H + h) * N;    // this head's vectors
    const long kvec = (row * Hk + hk) * N;  // its q / k (mode 2)
    __syncthreads();  // the previous step's reads of sv are done
    if (MODE == 0) {
      sv[0][j] = r[vec + j];
      sv[1][j] = k[vec + j];
      sv[2][j] = w[vec + j];
    } else if (MODE == 1) {
      sv[0][j] = r[vec + j];
      sv[1][j] = w[vec + j];
      sv[2][j] = k[vec + j];
      sv[3][j] = e[vec + j];  // kk
      sv[4][j] = f[vec + j];  // a
    } else {
      sv[0][j] = r[kvec + j];  // q
      sv[1][j] = k[kvec + j];
    }
    const float vj = v[vec + j];
    __syncthreads();
    const bool upd = t < L;
    float acc = 0.f;
    if (MODE == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float kv = upd ? sv[1][i] * vj : 0.f;
        acc += sv[0][i] * (st[i] + sv[4][i] * kv);
        if (upd) st[i] = sv[2][i] * st[i] + kv;
      }
    } else if (MODE == 1) {
      if (upd) {
        float sa = 0.f;
#pragma unroll
        for (int l = 0; l < N; ++l) sa += st[l] * (-sv[3][l]);
#pragma unroll
        for (int l = 0; l < N; ++l)
          st[l] = st[l] * sv[1][l] + sa * (sv[3][l] * sv[4][l]) +
                  vj * sv[2][l];
      }
#pragma unroll
      for (int l = 0; l < N; ++l) acc += st[l] * sv[0][l];
    } else {
      if (upd) {
        const float al = e[row * H + h];
        const float be = f[row * H + h];
        float kv = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          st[i] = st[i] * al;
          kv += st[i] * sv[1][i];
        }
        const float d = (vj - kv) * be;
#pragma unroll
        for (int i = 0; i < N; ++i) st[i] = st[i] + sv[1][i] * d;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) acc += st[i] * sv[0][i];
    }
    y[vec + j] = acc;
  }
  if (L > 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (MODE == 1)
        state[sbase + (long)j * N + i] = st[i];
      else
        state[sbase + (long)i * N + j] = st[i];
    }
  }
}

template <int N>
int by_mode(int mode, const float* r, const float* k, const float* v,
            const float* w, const float* e, const float* f, const float* u,
            const int* seq_lens, float* state, float* y, int S, int T, int H,
            int Hk, cudaStream_t st) {
  const dim3 grid((unsigned)H, (unsigned)S);
  if (mode == 0)
    wkv_kernel<N, 0><<<grid, N, 0, st>>>(r, k, v, w, e, f, u, seq_lens,
                                         state, y, T, H, Hk);
  else if (mode == 1)
    wkv_kernel<N, 1><<<grid, N, 0, st>>>(r, k, v, w, e, f, u, seq_lens,
                                         state, y, T, H, Hk);
  else
    wkv_kernel<N, 2><<<grid, N, 0, st>>>(r, k, v, w, e, f, u, seq_lens,
                                         state, y, T, H, Hk);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0 (rwkv6): r, k, v, w [S, T, H, N], u [H, N], e = f = null.
// mode 1 (rwkv7): r, w, k, v, e = kk, f = a [S, T, H, N], u = null.
// mode 2 (delta rule): r = q, k [S, T, Hk, N], v [S, T, H, N], e = alpha,
// f = beta [S, T, H], w = u = null; Hk divides H.
// seq_lens [S] int32; state [S, H, N, N] in place; y [S, T, H, N]. All
// f32 (but seq_lens), contiguous, on the device. Returns cudaGetLastError()
// after the launch, or -1 for a configuration the kernel does not take.
extern "C" int lbt_wkv(int mode, const void* r, const void* k, const void* v,
                       const void* w, const void* e, const void* f,
                       const void* u, const void* seq_lens, void* state,
                       void* y, int S, int T, int H, int Hk, int N,
                       void* stream) {
  if (mode < 0 || mode > 2 || S < 0 || T < 0 || H < 1 || Hk < 1 || H % Hk)
    return LBT_UNSUPPORTED;
  if (S == 0 || T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define LBT_WKV_ARGS                                                       \
  mode, (const float*)r, (const float*)k, (const float*)v, (const float*)w, \
      (const float*)e, (const float*)f, (const float*)u,                    \
      (const int*)seq_lens, (float*)state, (float*)y, S, T, H, Hk, st
  if (N == 16) return by_mode<16>(LBT_WKV_ARGS);
  if (N == 32) return by_mode<32>(LBT_WKV_ARGS);
  if (N == 64) return by_mode<64>(LBT_WKV_ARGS);
  if (N == 128) return by_mode<128>(LBT_WKV_ARGS);
#undef LBT_WKV_ARGS
  return LBT_UNSUPPORTED;
}
