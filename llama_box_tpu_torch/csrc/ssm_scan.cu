// The selective scan of the mamba mixers: mamba1 (a decay per channel and
// state) and mamba2 / SSD (a scalar decay per head, B and C shared by a
// group of heads), over a chunk of T rows a slot, the state carried in
// registers along T and updated in place.
//
// Replaces no Pallas kernel: the JAX package runs the recurrence as
// jax.lax.associative_scan (models/mamba._mixer, _mixer2), an XLA op. In
// torch that is either a loop of T steps of about ten kernels each, or a
// log-step scan that materializes [S, T, C, ds] f32 a layer; this kernel
// walks T once, the state in registers.
//
// Rule, for each slot s, channel c (head c / hd) and state n, at rows
// t < seq_lens[s]:
//   h[n] = exp(dt_t * A) * h[n] + (dt_t * x_t) * B_t[n]
// and at every row t (rows at and after seq_lens[s] read the frozen
// state, as JAX's identity elements leave it):
//   y_t = sum_n h[n] * C_t[n] + D * x_t.
// mamba1: A [C, ds] (a_per_state), dt [S, T, C], D [C] (hd = 1); mamba2:
// A [nh], dt [S, T, nh], D [nh], channel c in head c / hd. B, C [S, T, G,
// ds]: head h reads group h / (nh / G). x, y [S, T, C]; the state [S, C,
// ds] (mamba2's [S, nh, hd, ds] is the same memory). All f32. A slot with
// seq_lens 0 leaves its state unread-back and unwritten.
//
// Layout: LANES threads a channel, each holding NPL states (n = lane,
// lane + LANES, ...: neighbouring lanes read neighbouring B / C elements);
// the partial sums of y meet in a fixed xor-shuffle tree. Every row takes
// the same code whatever T, so a prefill of P + Q rows gives the state and
// outputs of a prefill of P then Q bit for bit, and a one-row decode step
// those of a one-row prefill.
//
// What bounds it: bytes (x, dt, B, C read once a row, y written once, the
// state read and written once a call) at large widths; at decode widths
// the latency of T dependent steps.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int LANES, int NPL>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ Cm, const float* __restrict__ D,
                    const int* __restrict__ seq_lens,
                    float* __restrict__ state, float* __restrict__ y, int T,
                    int C, int hd, int G, int ds, int a_per_state) {
  const int s = blockIdx.y;
  const int lane = threadIdx.x % LANES;
  const int c = blockIdx.x * (kThreads / LANES) + threadIdx.x / LANES;
  // a channel's lanes leave together: the shuffles see all of them
  if (c >= C) return;
  const unsigned mask =
      LANES == 32 ? 0xffffffffu
                  : ((1u << LANES) - 1u) << ((threadIdx.x & 31) & ~(LANES - 1));
  const int nh = C / hd;
  const int head = c / hd;
  const int g = head / (nh / G);
  const int L = seq_lens[s];
  const long sbase = ((long)s * C + c) * ds;

  float h[NPL], a[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = lane + j * LANES;
    h[j] = n < ds ? state[sbase + n] : 0.f;
    a[j] = n < ds ? (a_per_state ? A[(long)c * ds + n] : A[head]) : 0.f;
  }
  const float dv = D[head];

  for (int t = 0; t < T; ++t) {
    const long row = (long)s * T + t;
    const float xv = x[row * C + c];
    const float dtv = dt[row * nh + head];
    const float* Bt = B + (row * G + g) * ds;
    const float* Ct = Cm + (row * G + g) * ds;
    const bool upd = t < L;
    const float dx = dtv * xv;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = lane + j * LANES;
      if (n < ds) {
        if (upd) {
          const float dA = expf(dtv * a[j]);
          h[j] = dA * h[j] + dx * Bt[n];
        }
        acc += h[j] * Ct[n];
      }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(mask, acc, off, LANES);
    if (lane == 0) y[row * C + c] = acc + dv * xv;
  }
  if (L > 0) {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = lane + j * LANES;
      if (n < ds) state[sbase + n] = h[j];
    }
  }
}

template <int LANES, int NPL>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* Cm, const float* D, const int* seq_lens,
           float* state, float* y, int S, int T, int C, int hd, int G,
           int ds, int a_per_state, cudaStream_t st) {
  constexpr int per_block = kThreads / LANES;
  const dim3 grid((unsigned)((C + per_block - 1) / per_block), (unsigned)S);
  ssm_scan_kernel<LANES, NPL><<<grid, kThreads, 0, st>>>(
      x, dt, A, B, Cm, D, seq_lens, state, y, T, C, hd, G, ds, a_per_state);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y [S, T, C]; dt [S, T, C / hd]; A [C, ds] (a_per_state 1) or [C /
// hd]; B, Cm [S, T, G, ds]; D [C / hd]; seq_lens [S] int32; state [S, C,
// ds], updated in place. All f32 (but seq_lens), contiguous, on the device.
// hd divides C, G divides C / hd, ds <= 256. Returns cudaGetLastError()
// after the launch, or -1 for a configuration the kernel does not take.
extern "C" int lbt_ssm_scan(const void* x, const void* dt, const void* A,
                            const void* B, const void* Cm, const void* D,
                            const void* seq_lens, void* state, void* y, int S,
                            int T, int C, int hd, int G, int ds,
                            int a_per_state, void* stream) {
  if (S < 0 || T < 0 || C < 1 || hd < 1 || G < 1 || ds < 1 || C % hd ||
      (C / hd) % G)
    return LBT_UNSUPPORTED;
  if (S == 0 || T == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto lanes, auto npl) {
    return launch<decltype(lanes)::value, decltype(npl)::value>(
        (const float*)x, (const float*)dt, (const float*)A, (const float*)B,
        (const float*)Cm, (const float*)D, (const int*)seq_lens,
        (float*)state, (float*)y, S, T, C, hd, G, ds, a_per_state, st);
  };
  using I4 = std::integral_constant<int, 4>;
  using I8 = std::integral_constant<int, 8>;
  using I16 = std::integral_constant<int, 16>;
  using I32 = std::integral_constant<int, 32>;
  if (ds <= 16) return go(I4{}, I4{});
  if (ds <= 32) return go(I8{}, I4{});
  if (ds <= 64) return go(I16{}, I4{});
  if (ds <= 128) return go(I32{}, I4{});
  if (ds <= 256) return go(I32{}, I8{});
  return LBT_UNSUPPORTED;
}
