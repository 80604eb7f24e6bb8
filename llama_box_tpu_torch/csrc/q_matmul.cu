// The Q4 group-dequant matmul: out [M, N] f32 = bf16(x) . bf16(s*q - m),
// with w[i, n] = scales[i / group, n] * q[i, n] - mins[i / group, n] and the
// codes nibble-packed, dequantized inside the kernel (f32 multiply, f32
// subtract, one rounding to bf16) and the products summed in f32.
//
// Replaces _q4_kernel (llama_box_tpu/ops/qmatmul.py:202, entry
// lbt_q4_matmul) behind q_matmul_pallas: every 4-bit projection of the
// nibble-packed residency (LLAMA_BOX_TPU_PACKED4 / _Q4_F32SCALES). The int8
// codes' kernel (_q8_kernel) is q8_matmul.cu.
//
// What bounds it: at decode widths (M <= 64 rows; 4 in the server) the
// bytes of the codes and scales, 0.5 bytes a weight plus the scales; at
// prefill widths (M = 2048) the bf16 products, 2*M*K*N operations.
//
// Design: one tensor-core GEMM. A block owns 64 output columns and BM rows
// (16 at decode widths, 64 above) and walks the in-dim in tiles of 64
// weight rows. Per tile it stages the x rows as bf16 in shared memory
// [BM][k], and dequantizes the weights into shared memory transposed to
// [n][k], so that the B operand of mma.sync.m16n8k16 (bf16 x bf16 -> f32)
// is one 32-bit load of two consecutive k. A packed tile is 32 byte rows:
// byte row r gives weight rows r (low nibble) and r + K/2 (high nibble),
// which meet x columns r and r + K/2, so the tile's k index 0..31 holds the
// low rows and 32..63 the high ones. Codes are read as unsigned bytes.
//
// At decode widths 64-column blocks are few (40 for TinyLlama's wqkv), so
// the in-dim is split across gridDim.z blocks, each writing its partial
// sums to a workspace [S, M, N]; a second kernel adds them in split order.
// No atomics: every output element is the same sequence of f32 operations
// in every run and for every other row of the call, so greedy decoding is
// deterministic. Rows 16 at a time waste no mma work at M = 4 beyond the
// 16-row tile. No cp.async pipelining yet: q8_matmul.cu has the pipelined
// design with the split sum folded in, to be carried over to the packed
// layout.
#include "q_common.cuh"

namespace {

using namespace lbt_q;

constexpr int BN = 64;          // output columns per block
constexpr int BK = 64;          // weight rows (logical k) per tile
constexpr int LDS = BK + 8;     // 36 words a row: conflict-free fragments
constexpr int kThreads = 128;
constexpr int kSmallRows = 64;  // up to this many rows: 16-row blocks

struct Args {
  const void* x;
  const int8_t* qs;
  const void* sc;
  const void* mn;
  float* ws;
  float* out;
  int M, K, N, gshift, splits;
};

template <typename XT, typename ST, bool HAS_MIN, int BM>
__global__ void __launch_bounds__(kThreads) q_gemm_kernel(Args a) {
  constexpr int WM = BM >= 32 ? BM / 32 : 1;   // warps along the rows
  constexpr int WN = 4 / WM;                    // warps along the columns
  constexpr int MT = BM / WM / 16;              // m16 tiles per warp
  constexpr int NT = BN / WN / 8;               // n8 tiles per warp
  constexpr int BROWS = BK / 2;                 // code byte rows per tile
  constexpr int RP = BROWS / 2;                 // byte-row pairs per tile
  __shared__ __align__(16) bf16 As[BM][LDS];   // [m][k]
  __shared__ __align__(16) bf16 Bs[BN][LDS];   // [n][k]

  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  const int8_t* __restrict__ qs = a.qs;
  const ST* __restrict__ sc = static_cast<const ST*>(a.sc);
  const ST* __restrict__ mn = static_cast<const ST*>(a.mn);
  const int M = a.M, K = a.K, N = a.N, half = K / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = K / BK, s = blockIdx.z, S = gridDim.z;
  const int t0 = (int)((long)ktiles * s / S);
  const int t1 = (int)((long)ktiles * (s + 1) / S);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = t0; t < t1; ++t) {
    // x rows -> As, 8 k a thread-step: k 0..31 are x columns t*32..,
    // k 32..63 are columns K/2 + t*32..
    for (int i = tid; i < BM * (BK / 8); i += kThreads) {
      const int row = i / (BK / 8), kc = i % (BK / 8);
      const int col = kc < 4 ? t * 32 + kc * 8
                             : half + t * 32 + (kc - 4) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < M) v = x8(x + (long)(m0 + row) * K + col);
      *reinterpret_cast<uint4*>(&As[row][kc * 8]) = v;
    }
    // codes -> dequantized bf16 weights in Bs[n][k]: a thread-step takes
    // two consecutive byte rows of 8 columns
    for (int i = tid; i < RP * (BN / 8); i += kThreads) {
      const int rp = i % RP, cg = i / RP;
      const int br = t * BROWS + 2 * rp;           // first byte row
      const int c = n0 + cg * 8;
      uint32_t lo[8], hi[8];
      if (c < N) {
        const uint2 r0 = __ldg(reinterpret_cast<const uint2*>(
            qs + (long)br * N + c));
        const uint2 r1 = __ldg(reinterpret_cast<const uint2*>(
            qs + (long)(br + 1) * N + c));
        float s_lo[8], m_lo[8] = {};
        s8(sc + (long)(br >> a.gshift) * N + c, s_lo);
        if (HAS_MIN) s8(mn + (long)(br >> a.gshift) * N + c, m_lo);
        float s_hi[8], m_hi[8] = {};
        const long gh = (long)((half + br) >> a.gshift) * N + c;
        s8(sc + gh, s_hi);
        if (HAS_MIN) s8(mn + gh, m_hi);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t b0 = byte_of(r0, j), b1 = byte_of(r1, j);
          lo[j] = lbt_pack_bf16(
              deq<HAS_MIN>((float)(b0 & 15u), s_lo[j], m_lo[j]),
              deq<HAS_MIN>((float)(b1 & 15u), s_lo[j], m_lo[j]));
          hi[j] = lbt_pack_bf16(
              deq<HAS_MIN>((float)(b0 >> 4), s_hi[j], m_hi[j]),
              deq<HAS_MIN>((float)(b1 >> 4), s_hi[j], m_hi[j]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) lo[j] = hi[j] = 0u;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(&Bs[cg * 8 + j][2 * rp]) = lo[j];
        *reinterpret_cast<uint32_t*>(&Bs[cg * 8 + j][BK / 2 + 2 * rp]) = hi[j];
      }
    }
    __syncthreads();
    // fragments (PTX m16n8k16 .bf16): a0 rows g / g+8, k 2*tig (+8);
    // b k 2*tig (+8), column g
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * (BM / WM) + mt * 16 + g;
        af[mt][0] = lds32(&As[r][kk + 2 * tig]);
        af[mt][1] = lds32(&As[r + 8][kk + 2 * tig]);
        af[mt][2] = lds32(&As[r][kk + 8 + 2 * tig]);
        af[mt][3] = lds32(&As[r + 8][kk + 8 + 2 * tig]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int cn = wn * (BN / WN) + nt * 8 + g;
        bfr[nt][0] = lds32(&Bs[cn][kk + 2 * tig]);
        bfr[nt][1] = lds32(&Bs[cn][kk + 8 + 2 * tig]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          lbt_mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
    __syncthreads();
  }
  // accumulator fragment: c0, c1 at row g, columns 2*tig, 2*tig + 1;
  // c2, c3 at row g + 8
  float* dst = S > 1 ? a.ws + (long)s * M * N : a.out;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * (BM / WM) + mt * 16 + g + h * 8;
        const int c = n0 + wn * (BN / WN) + nt * 8 + 2 * tig;
        if (r < M && c < N) {
          dst[(long)r * N + c] = acc[mt][nt][2 * h];
          dst[(long)r * N + c + 1] = acc[mt][nt][2 * h + 1];
        }
      }
}

// out = ws[0] + ws[1] + ... + ws[S-1], in split order
__global__ void splitk_sum_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int S, long MN) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = ws[i];
  for (int s = 1; s < S; ++s) v += ws[s * MN + i];
  out[i] = v;
}

template <typename XT, typename ST, bool HAS_MIN, int BM>
int run(const Args& a, cudaStream_t st) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.splits);
  q_gemm_kernel<XT, ST, HAS_MIN, BM><<<grid, kThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  const long mn = (long)a.M * a.N;
  splitk_sum_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      a.ws, a.out, a.splits, mn);
  return (int)cudaGetLastError();
}

template <typename XT, typename ST, bool HAS_MIN>
int by_rows(const Args& a, cudaStream_t st) {
  return a.M <= kSmallRows ? run<XT, ST, HAS_MIN, 16>(a, st)
                           : run<XT, ST, HAS_MIN, 64>(a, st);
}

template <typename XT, typename ST>
int by_min(const Args& a, cudaStream_t st) {
  return a.mn ? by_rows<XT, ST, true>(a, st) : by_rows<XT, ST, false>(a, st);
}

template <typename XT>
int by_scale(int s_dtype, const Args& a, cudaStream_t st) {
  if (s_dtype == LBT_BF16) return by_min<XT, bf16>(a, st);
  if (s_dtype == LBT_F32) return by_min<XT, float>(a, st);
  return LBT_UNSUPPORTED;
}

}  // namespace

// x [M, K] (bf16 or f32, x_dtype as LbtDtype); qs int8 [K/2, N] nibble-
// packed; scales and mins [K/group, N] of s_dtype (bf16 or f32), mins
// nullable; ws f32 [splits, M, N] scratch when splits > 1 (else nullable);
// out [M, N] f32. All contiguous on the device and 16-byte aligned; K a
// multiple of 64, N of 8, group a power of two <= 32, 1 <= splits <= K/64.
// Returns the first non-zero cudaGetLastError() of the launches, or -1 for
// a configuration the kernels do not take.
extern "C" int lbt_q4_matmul(int x_dtype, int s_dtype, const void* x,
                             const void* qs, const void* scales,
                             const void* mins, void* ws, void* out, int M,
                             int K, int N, int group, int splits,
                             void* stream) {
  const int gshift = group_shift(group);
  if (M < 1 || K < BK || K % BK || N < 8 || N % 8 || gshift < 0 ||
      splits < 1 || splits > K / BK || (splits > 1 && !ws) ||
      (M + 15) / 16 > 65535 || splits > 65535)
    return LBT_UNSUPPORTED;
  const Args a{x, (const int8_t*)qs, scales, mins, (float*)ws, (float*)out,
               M, K, N, gshift, splits};
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == LBT_BF16) return by_scale<bf16>(s_dtype, a, st);
  if (x_dtype == LBT_F32) return by_scale<float>(s_dtype, a, st);
  return LBT_UNSUPPORTED;
}
