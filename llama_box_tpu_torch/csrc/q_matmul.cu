// The grouped dequant matmuls: out [M, N] = bf16(x) . bf16(s*q - m), with
// w[i, n] = scales[i / group, n] * q[i, n] - mins[i / group, n], dequantized
// inside the kernel (f32 multiply, f32 subtract, one rounding to bf16) and
// the products summed in f32; out f32, or bf16 rounded once from the f32
// sum (as torch's .to(bfloat16)). Two code layouts, one kernel template:
// - lbt_q4_matmul (PACKED4): nibble-packed codes [K/2, N], byte row r holds
//   weight row r in its low nibble and row r + K/2 in its high nibble,
//   codes read as unsigned. Replaces _q4_kernel
//   (llama_box_tpu/ops/qmatmul.py:202) behind q_matmul_pallas: every 4-bit
//   projection of the nibble-packed residency (LLAMA_BOX_TPU_PACKED4 /
//   _Q4_F32SCALES).
// - lbt_q8_matmul: int8 codes [K, N]. Replaces _q8_kernel
//   (llama_box_tpu/ops/qmatmul.py:237): every int8-code projection of a
//   grouped residency (Q6_K and Q8_0 weights, and all 4-bit ones under
//   LLAMA_BOX_TPU_Q4_INT8).
//
// What bounds it: at decode widths (M <= 64 rows; 4 in the server) the
// bytes of the codes and scales, 1 byte a weight (half a byte packed) plus
// the scales; at prefill widths (M = 2048) the bf16 products, 2*M*K*N
// operations.
//
// Design: a block of 8 warps owns 128 output columns and BM rows (16 at
// decode widths, 256 above) and walks its share of the in-dim in tiles of
// 64 weight rows through a ring of STAGES shared-memory stages (6 at decode
// widths, 3 above). Each stage holds the raw tile: the x rows as bf16
// [BM][64], the code bytes [64][128] (packed: [32][128]) and the tile's
// scale and min rows, all copied by cp.async (16-byte copies; 8-byte code
// copies when N is not a multiple of 16), so that STAGES - 2 tiles are in
// flight beyond the two being worked on. f32 x rows are converted to bf16
// as they are staged. A packed tile t is byte rows t*32 .. t*32+31: its k
// 0..31 are their low nibbles (weight rows t*32 ..), met by x columns
// t*32 .., and its k 32..63 their high nibbles (rows K/2 + t*32 ..), met
// by x columns K/2 + t*32 ..; the stage copies those two x column ranges
// and the two ranges' scale rows, so after the dequant pass a packed tile
// is an int8 one of 64 rows.
// A pass dequantizes a stage's codes into a bf16 tile Bs, double-
// buffered: tile it + 1's pass runs beside tile it's products, so the ALU
// work overlaps the tensor cores and one barrier a tile suffices. The pass
// is the kernel's ALU cost (every weight of a tile, whatever M), and it
// issues no integer-to-float conversion (a code byte becomes the low
// mantissa bits of 2^23, then 2^23 is subtracted: exact) and one paired
// f32-to-bf16 conversion for two weights, since conversions issue at a
// quarter of the rate of the f32 multiply and subtract around them.
// - Above 64 rows (prefill), two warpgroups of 128 rows issue wgmma
//   m64n128k16 (bf16 x bf16 -> f32) for the whole tile, A from the x
//   stage (K-major) and B from Bs (MN-major, so the [K, N] code layout
//   needs no change), both 128-byte swizzled, and dequantize the next tile
//   while the tensor cores run.
// - At decode widths each warp owns 16 x 16 of the output; ldmatrix
//   (.trans for B, one k-step ahead) feeds mma.sync.m16n8k16, a row of the
//   next tile dequantized per k-step.
// Columns past N and rows past M are zero-filled by the copies and never
// written. Group 2 with f32 scales and mins needs more shared memory than
// a block has, in both layouts, and is refused (returns -1).
//
// At decode widths the in-dim is split across gridDim.z blocks, chosen from
// the weight's shape alone (ops/qmatmul.py). Each block writes its partial
// sums to a workspace [S, M, N] and takes a ticket from its tile's counter;
// the block that arrives last sums the S partials in split order, writes
// the output and resets the counter to 0 for the next call, so a call is
// one launch and the counters need no clearing. The only atomic is the
// ticket: every output element is the same sequence of f32 operations in
// every run and for every other row of the call (greedy decoding is
// deterministic). Calls that share a counter buffer must run on one stream.
#include <utility>

#include "q_common.cuh"

namespace {

using namespace lbt_q;

constexpr int BN = 128;        // output columns per block
constexpr int BK = 64;         // weight rows (logical k) per tile
constexpr int XLD = BK + 8;    // As row: 144 bytes, ldmatrix conflict-free
constexpr int BLD = BN + 8;    // Bs row: 272 bytes
constexpr int kSmallRows = 64;
constexpr int kMaxSplits = 16;
constexpr int kThreads = 256;  // 8 warps
// prefill widths (BM > 16): wgmma from 128-byte-swizzled tiles, As
// K-major rows of 64 k and Bs MN-major atoms of 64 n x 64 k, no padding
template <int BM>
constexpr bool kWG = BM > 16;
template <int BM>
constexpr int kALD = kWG<BM> ? BK : XLD;              // As row, elements
template <int BM>
constexpr int kBSZ = kWG<BM> ? BK * BN : BK * BLD;    // one Bs, elements
constexpr int kMaxSmem = 232448 - 1024;  // 227 KB less the static bytes

struct Args {
  const void* x;
  const int8_t* qs;
  const void* sc;
  const void* mn;
  float* ws;
  unsigned* cnt;
  void* out;
  int M, K, N, gshift, out_bf16, stage_bytes;
};

template <typename XT, typename ST, bool HAS_MIN, bool PACKED4, int BM,
          int STAGES>
__global__ void __launch_bounds__(kThreads, kWG<BM> ? 1 : 2)
    grouped_gemm_kernel(Args a) {
  constexpr bool WG = kWG<BM>;
  constexpr int ALD = kALD<BM>, BSZ = kBSZ<BM>;
  constexpr int CROWS = PACKED4 ? BK / 2 : BK;  // code byte rows per tile
  // accumulators: a warp's 16 x 16 as two m16n8 tiles (mma.sync), or a
  // warpgroup's BM / 2 rows as m64 tiles of 16 n8 blocks (wgmma)
  constexpr int MT = WG ? BM / 128 : 1;
  constexpr int NT = WG ? BN / 8 : 2;
  constexpr int SCOLS = 16 / sizeof(ST);  // scale columns per 16 bytes
  static_assert(WG ? BM % 128 == 0 : BM == 16, "warp tiling");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;

  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  const int8_t* __restrict__ qs = a.qs;
  const ST* __restrict__ sc = static_cast<const ST*>(a.sc);
  const ST* __restrict__ mn = static_cast<const ST*>(a.mn);
  const int M = a.M, K = a.K, N = a.N, gshift = a.gshift;
  const int SR = BK >> gshift;          // scale rows per tile
  const bool vec16 = (N & 15) == 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = K / BK, s = blockIdx.z, S = gridDim.z;
  const int t0 = (int)((long)ktiles * s / S);
  const int t1 = (int)((long)ktiles * (s + 1) / S);
  const int ntiles = t1 - t0;

  // swizzled tiles start on 1024-byte boundaries
  unsigned char* const smem =
      WG ? smem_raw + ((1024 - (lbt_smem(smem_raw) & 1023)) & 1023)
         : smem_raw;
  bf16* const Bs = reinterpret_cast<bf16*>(smem);
  auto stage_of = [&](int i) {
    return smem + 4 * BSZ + i * a.stage_bytes;
  };

  // raw tile t -> stage i: x rows, code bytes, scale and min rows
  auto stage = [&](int t, int i) {
    unsigned char* base = stage_of(i);
    bf16* As = reinterpret_cast<bf16*>(base);
    int8_t* Cs = reinterpret_cast<int8_t*>(base + BM * ALD * 2);
    ST* Ss = reinterpret_cast<ST*>(base + BM * ALD * 2 + CROWS * BN);
    ST* Ms = Ss + SR * BN;
    for (int j = tid; j < BM * (BK / 8); j += kThreads) {
      const int row = j >> 3, kc = j & 7;
      const bool ok = m0 + row < M;
      // packed: k 0..31 from columns t*32 .., k 32..63 from K/2 + t*32 ..
      const int col = PACKED4
                          ? t * (BK / 2) + (kc & 3) * 8 + (kc >> 2) * (K / 2)
                          : t * BK + kc * 8;
      const XT* src = x + (long)(ok ? m0 + row : 0) * K + col;
      bf16* dst = As + row * ALD + (WG ? kc ^ (row & 7) : kc) * 8;
      if constexpr (std::is_same<XT, bf16>::value) {
        lbt_cp16(dst, src, ok);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            ok ? x8(src) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    const int8_t* q0 = qs + (long)t * CROWS * N;
    if (vec16) {
      for (int j = tid; j < CROWS * (BN / 16); j += kThreads) {
        const int r = j / (BN / 16), c = (j % (BN / 16)) * 16;
        const bool ok = n0 + c < N;
        lbt_cp16(Cs + r * BN + c, q0 + (long)r * N + (ok ? n0 + c : 0), ok);
      }
    } else {
      for (int j = tid; j < CROWS * (BN / 8); j += kThreads) {
        const int r = j / (BN / 8), c = (j % (BN / 8)) * 8;
        const bool ok = n0 + c < N;
        lbt_cp8(Cs + r * BN + c, q0 + (long)r * N + (ok ? n0 + c : 0), ok);
      }
    }
    // scale row r of the stage is group row srow(r): packed, the first
    // SR / 2 are the low half's groups and the rest the high half's, so
    // that row k >> gshift serves the tile's k in both layouts
    auto srow = [&](int r) -> long {
      if (!PACKED4) return ((t * BK) >> gshift) + r;
      const int hi = r >= SR / 2;
      return ((t * (BK / 2) + hi * (K / 2)) >> gshift) + r - hi * (SR / 2);
    };
    for (int j = tid; j < SR * (BN / SCOLS); j += kThreads) {
      const int r = j / (BN / SCOLS), c = (j % (BN / SCOLS)) * SCOLS;
      const bool ok = n0 + c < N;
      const long off = srow(r) * N + (ok ? n0 + c : 0);
      lbt_cp16(Ss + r * BN + c, sc + off, ok);
      if (HAS_MIN) lbt_cp16(Ms + r * BN + c, mn + off, ok);
    }
  };

  // dequant pass: thread tid takes rows kq .. kq+3 of columns cq .. cq+7
  // of a tile, one row a part, into Bs[b] ([k][n], or the swizzled atoms);
  // its group's scales (and mins) are read once (twice for group 2).
  // Packed, row k is byte row k % 32's low (k < 32) or high nibble.
  static_assert(kThreads == (BK / 4) * (BN / 8), "one row quad a thread");
  const int kq = (tid / (BN / 8)) * 4, cq = (tid % (BN / 8)) * 8;
  float sv[8], mv[8] = {};
  auto dequant = [&](int i, int b, int r) {
    const unsigned char* base = stage_of(i);
    const int8_t* Cs = reinterpret_cast<const int8_t*>(base + BM * ALD * 2);
    const ST* Ss =
        reinterpret_cast<const ST*>(base + BM * ALD * 2 + CROWS * BN);
    const ST* Ms = Ss + SR * BN;
    const int kl = kq + r;
    if (r == 0 || (r == 2 && gshift == 1)) {
      s8(Ss + (kl >> gshift) * BN + cq, sv);
      if (HAS_MIN) s8(Ms + (kl >> gshift) * BN + cq, mv);
    }
    // the row's 8 codes as bytes: packed, its nibbles (unsigned); else
    // the int8 codes ^ 0x80 (unsigned, offset by 128)
    const uint2 raw =
        *reinterpret_cast<const uint2*>(Cs + (kl % CROWS) * BN + cq);
    uint32_t cw[2] = {raw.x, raw.y};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      cw[h] = PACKED4 ? (kl < BK / 2 ? cw[h] : cw[h] >> 4) & 0x0F0F0F0Fu
                      : cw[h] ^ 0x80808080u;
    constexpr float bias = PACKED4 ? LBT_U8_BIAS : LBT_S8_BIAS;
    auto code = [&](int e) { return lbt_byte_f(cw[e >> 2], e & 3, bias); };
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = lbt_pack_bf16(
          deq<HAS_MIN>(code(2 * e), sv[2 * e], mv[2 * e]),
          deq<HAS_MIN>(code(2 * e + 1), sv[2 * e + 1], mv[2 * e + 1]));
    bf16* dst = Bs + b * BSZ + kl * BLD + cq;
    if constexpr (WG)   // atom cq / 64: rows of 64 n, chunk ^= k % 8
      dst = Bs + b * BSZ + (cq >> 6) * (BK * 64) + kl * 64 +
            ((((cq & 63) >> 3) ^ (kl & 7)) << 3);
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // mma.sync fragments (PTX m16n8k16 .bf16) by ldmatrix: A from As[m][k],
  // matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15); B transposed from
  // Bs[k][n], matrices (k 0-7 | 8-15) x (n 0-7 | 8-15), the warp's two n8
  // tiles
  auto frags = [&](const bf16* As, const bf16* B, int kk,
                   uint32_t (&af)[4], uint32_t (&bfr)[2][2]) {
    lbt_ldsm4(af, As + (lane & 15) * XLD + kk + (lane >> 4) * 8);
    uint32_t r[4];
    lbt_ldsm4_t(r, B + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * BLD +
                       warp * 16 + (lane >> 4) * 8);
    bfr[0][0] = r[0];
    bfr[0][1] = r[1];
    bfr[1][0] = r[2];
    bfr[1][1] = r[3];
  };
  // one tile's products beside the next tile's dequant pass (stage di into
  // Bs[db], when dq). wgmma: the tile's products issued at once (A: the
  // warpgroup's K-major rows, 32 bytes a k-step; B: atoms 8 KB apart along
  // n, 8-row groups 1 KB apart along k), then the whole pass, then the
  // wait. mma.sync: each k-step's fragments loaded before the previous
  // k-step's mma, a row of the pass per k-step.
  auto products = [&](int i, int b, bool dq, int di, int db) {
    if constexpr (WG) {
      const uint32_t a0 =
          lbt_smem(stage_of(i)) + (warp >> 2) * (BM / 2) * BK * 2;
      const uint32_t b0 = lbt_smem(Bs + b * BSZ);
      lbt_wg_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          lbt_wgmma_128(acc[mt],
                        lbt_wg_desc(a0 + mt * 64 * BK * 2 + ks * 32, 16, 1024),
                        lbt_wg_desc(b0 + ks * 16 * 128, 64 * 128, 1024));
      lbt_wg_commit();
      if (dq)
#pragma unroll
        for (int r = 0; r < 4; ++r) dequant(di, db, r);
      lbt_wg_wait0();
    } else {
      const bf16* As = reinterpret_cast<const bf16*>(stage_of(i));
      const bf16* B = Bs + b * BSZ;
      uint32_t af[2][4], bfr[2][2][2];
      frags(As, B, 0, af[0], bfr[0]);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        if (ks + 1 < BK / 16)
          frags(As, B, (ks + 1) * 16, af[(ks + 1) & 1], bfr[(ks + 1) & 1]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          lbt_mma_bf16(acc[0][nt], af[ks & 1], bfr[ks & 1][nt]);
        if (dq) dequant(di, db, ks);
      }
    }
  };

  // the ring: tiles it + 1 .. it + STAGES - 2 in flight while tile it's
  // products run beside tile it + 1's dequant pass. One barrier a tile:
  // after it, Bs[it & 1] is complete, and every thread is past products
  // (it - 1) and dequant (it), so stage (it - 1) % STAGES (x read by
  // products, codes by dequant) is refilled and Bs[(it + 1) & 1] rewritten
  static_assert(STAGES >= 3, "tile it + 1 staged while tile it computes");
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) stage(t0 + i, i);
    lbt_cp_commit();
  }
  if (ntiles > 0) {
    lbt_cp_wait<STAGES - 2>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) dequant(0, 0, r);
  }
  for (int it = 0; it < ntiles; ++it) {
    lbt_cp_wait<STAGES - 3>();      // tile it + 1 has landed
    if constexpr (WG) lbt_fence_proxy_async();
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < ntiles) stage(t0 + nx, nx % STAGES);
    lbt_cp_commit();
    products(it % STAGES, it & 1, it + 1 < ntiles, (it + 1) % STAGES,
             (it + 1) & 1);
  }
  lbt_cp_wait<0>();

  // accumulator fragment: c0, c1 at row g, columns 2*tig, 2*tig + 1;
  // c2, c3 at row g + 8
  auto put = [&](long off, float v0, float v1) {
    if (a.out_bf16)
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + off) =
          lbt_pack_bf16(v0, v1);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(a.out) + off) =
          make_float2(v0, v1);
  };
  float* part = a.ws + (long)s * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + h * 8 +
                      (WG ? (warp >> 2) * (BM / 2) + mt * 64 + (warp & 3) * 16
                          : 0);
        const int c = n0 + nt * 8 + 2 * tig + (WG ? 0 : warp * 16);
        if (r < M && c < N) {
          const long off = (long)r * N + c;
          if (S == 1)
            put(off, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          else
            *reinterpret_cast<float2*>(part + off) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
  if (S == 1) return;

  // split sum: the last block of this output tile adds the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned* c = a.cnt + blockIdx.y * gridDim.x + blockIdx.x;
    const bool last = atomicAdd(c, 1u) == (unsigned)(S - 1);
    if (last) atomicExch(c, 0u);
    is_last = last;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const long MN = (long)M * N;
  for (int j = tid; j < BM * (BN / 4); j += kThreads) {
    const int r = m0 + j / (BN / 4), c = n0 + (j % (BN / 4)) * 4;
    if (r >= M || c >= N) continue;
    const long off = (long)r * N + c;
    // every partial's load in flight at once, then the sum in split order
    float4 u[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < S)
        u[q] = __ldcg(reinterpret_cast<const float4*>(a.ws + q * MN + off));
    float4 v = u[0];
#pragma unroll
    for (int q = 1; q < kMaxSplits; ++q)
      if (q < S) {
        v.x += u[q].x;
        v.y += u[q].y;
        v.z += u[q].z;
        v.w += u[q].w;
      }
    put(off, v.x, v.y);
    put(off + 2, v.z, v.w);
  }
}

template <typename XT, typename ST, bool HAS_MIN, bool PACKED4, int BM,
          int STAGES>
int run(Args a, int splits, cudaStream_t st) {
  auto kern = grouped_gemm_kernel<XT, ST, HAS_MIN, PACKED4, BM, STAGES>;
  // shared memory: Bs and STAGES stages of (x rows, codes, scale and min
  // rows); only group 2 with f32 scales and mins needs more than a block
  // may have
  auto bytes = [](int sr) {
    int stage = BM * kALD<BM> * 2 + (PACKED4 ? BK / 2 : BK) * BN +
                (HAS_MIN ? 2 : 1) * sr * BN * (int)sizeof(ST);
    if (kWG<BM>) stage = (stage + 1023) / 1024 * 1024;
    return std::make_pair(stage, 4 * kBSZ<BM> + STAGES * stage +
                                     (kWG<BM> ? 1024 : 0));
  };
  static int allowed = 0;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    allowed = 1;
  }
  const auto b = bytes(BK >> a.gshift);
  if (b.second > kMaxSmem) return LBT_UNSUPPORTED;
  a.stage_bytes = b.first;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, splits);
  kern<<<grid, kThreads, b.second, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename XT, typename ST, bool HAS_MIN, bool PACKED4>
int by_rows(const Args& a, int splits, cudaStream_t st) {
  return a.M <= kSmallRows
             ? run<XT, ST, HAS_MIN, PACKED4, 16, 6>(a, splits, st)
             : run<XT, ST, HAS_MIN, PACKED4, 256, 3>(a, splits, st);
}

template <typename XT, typename ST, bool PACKED4>
int by_min(const Args& a, int splits, cudaStream_t st) {
  return a.mn ? by_rows<XT, ST, true, PACKED4>(a, splits, st)
              : by_rows<XT, ST, false, PACKED4>(a, splits, st);
}

template <typename XT, bool PACKED4>
int by_scale(int s_dtype, const Args& a, int splits, cudaStream_t st) {
  if (s_dtype == LBT_BF16) return by_min<XT, bf16, PACKED4>(a, splits, st);
  if (s_dtype == LBT_F32) return by_min<XT, float, PACKED4>(a, splits, st);
  return LBT_UNSUPPORTED;
}

template <bool PACKED4>
int entry(int x_dtype, int s_dtype, const void* x, const void* qs,
          const void* scales, const void* mins, void* ws, void* counters,
          void* out, int out_bf16, int M, int K, int N, int group, int splits,
          void* stream) {
  const int gshift = group_shift(group);
  if (M < 1 || K < BK || K % BK || N < 8 || N % 8 || gshift < 0 ||
      splits < 1 || splits > K / BK || splits > kMaxSplits ||
      (splits > 1 && (!ws || !counters || M > kSmallRows)) ||
      (M + 15) / 16 > 65535)
    return LBT_UNSUPPORTED;
  const Args a{x,        (const int8_t*)qs, scales, mins, (float*)ws,
               (unsigned*)counters, out, M, K, N, gshift, out_bf16 ? 1 : 0,
               0};
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == LBT_BF16)
    return by_scale<bf16, PACKED4>(s_dtype, a, splits, st);
  if (x_dtype == LBT_F32)
    return by_scale<float, PACKED4>(s_dtype, a, splits, st);
  return LBT_UNSUPPORTED;
}

}  // namespace

// x [M, K] (bf16 or f32, x_dtype as LbtDtype); qs int8 codes, [K/2, N]
// nibble-packed (lbt_q4_matmul) or [K, N] (lbt_q8_matmul); scales and mins
// [K/group, N] of s_dtype (bf16 or f32), mins nullable; out [M, N] f32, or
// bf16 when out_bf16. When splits > 1 (only for M <= 64): ws f32
// [splits, M, N] scratch and counters, (ceil(N/128) * ceil(M/16)) unsigned
// ints that are 0 before the call and are 0 again after it. All contiguous
// on the device and 16-byte aligned; K a multiple of 64, N of 8, group a
// power of two <= 32, 1 <= splits <= min(K/64, 16). Returns cudaGetLastError()
// after the launch, or -1 for a configuration the kernel does not take.
extern "C" int lbt_q4_matmul(int x_dtype, int s_dtype, const void* x,
                             const void* qs, const void* scales,
                             const void* mins, void* ws, void* counters,
                             void* out, int out_bf16, int M, int K, int N,
                             int group, int splits, void* stream) {
  return entry<true>(x_dtype, s_dtype, x, qs, scales, mins, ws, counters,
                     out, out_bf16, M, K, N, group, splits, stream);
}

extern "C" int lbt_q8_matmul(int x_dtype, int s_dtype, const void* x,
                             const void* qs, const void* scales,
                             const void* mins, void* ws, void* counters,
                             void* out, int out_bf16, int M, int K, int N,
                             int group, int splits, void* stream) {
  return entry<false>(x_dtype, s_dtype, x, qs, scales, mins, ws, counters,
                      out, out_bf16, M, K, N, group, splits, stream);
}
