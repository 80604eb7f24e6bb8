// Single-query attention for chained decode.
//
// Replaces the Pallas kernel _flash_decode_kernel / flash_decode
// (llama_box_tpu/ops/flash_decode.py:76, :158): one query row per slot and
// query head attends the read-only KV cache below the chain start and the
// chain's own rows (row i at position cpos - (nv-1) + i, rows >= nv dead).
//
// What bounds it: bytes. Each (slot, KV head) reads its visible K/V once,
// about 2 * cpos * D * 2 bytes at bf16, and does ~4 flops per byte read, far
// below the card's ~295 flop/byte ridge. The TPU kernel clamped its block
// index maps so dead blocks were never fetched; here only the visible span
// [window/chunk floor, cpos] is read, so traffic is proportional to each
// slot's position and dead positions are never read.
//
// Which kernel: a bf16 q (the served path; bf16 or int8 cache) takes
// flash_decode_mma_kernel, split across the SMs and on the tensor cores.
// An f32 q (f32 or int8 cache) takes flash_decode_fma_kernel, f32 FMAs:
// bf16 and TF32 tensor cores cannot hold an f32 q to the f32 tolerance.
// The choice is made by dtype in lbt_flash_decode, before any launch.
//
// flash_decode_mma_kernel: split-K over absolute key positions. Split z
// owns positions [z*L, (z+1)*L) (the last split also everything beyond),
// L and the split count S chosen from the cache capacity C alone
// (ops/flash_decode.py), so the grid is (Hkv, B, S) and the host never
// reads the device-side (cpos, nv); a block whose span holds no visible
// key exits at once. A block of 4 warps walks its span in 64-key tiles
// aligned to absolute positions through a 3-stage cp.async ring (an int8
// cache is dequantized through registers, code times row scale rounded to
// bf16 as kv_dequant does), each warp taking 16 keys of every tile for all
// G <= 16 query heads of the KV head: S = Q K^T and O += P V as
// mma.sync.m16n8k16 (bf16 x bf16 -> f32) from ldmatrix fragments (.trans
// for V), Q fragments in registers, the online softmax in base 2 in
// registers, and P rounded to bf16 before it weights V (the Pallas
// kernel's rounding point). The tile that straddles the chain start takes
// cache keys below it and row keys from it together, and a key outside the
// span or unreadable is staged as zero and masked, so a key's score and
// its place in the sums depend on its position alone, never on which
// operand held it nor on nv, R or B: greedy K=1 and K=16 chains give the
// same bits. The warps' states are merged in warp order, the block writes
// its split's (m, l, acc) per query head to a workspace and takes a ticket
// from its (slot, KV head)'s counter; the block with the last ticket (the
// live-split count comes from meta, the same way in every block) merges
// the live splits in split order, applies the sinks, writes the output and
// resets the counter, so a call is one launch. Calls that share the
// counters must run on one stream.
//
// Scores: s = q.k * scale, plus slope * (kpos - cpos) under ALiBi (one
// slope per query head, [Hkv, G] f32, null without), then the softcap,
// then the masks, as the JAX model's _attn_deferred orders them. Head
// widths D = DV in {64, 80, 96, 128, 256}, and multi-head latent
// attention's unequal K / V widths 192 / 128 and 96 / 64 (K tiles and Q by
// D, V tiles, the O accumulator, the partials and the output by DV); above
// D 128 the bf16 kernel reads Q from shared memory by ldmatrix (at D 256
// its 64 registers a thread would sit beside the 128 of the O
// accumulator), three 64-key stages of K and V plus Q staying under the
// 227 KB a block may hold.
//
// flash_decode_fma_kernel: one block per (slot, KV head), one warp per
// query head. Tiles are loaded 16 bytes per thread into registers one tile
// ahead of the compute. Lanes score the tile's keys in parallel; a warp
// max-scan gives every key the running max the keys before it reached, so
// the exponentials are computed in parallel, and the walk that folds them
// into (l, acc) in key order is a chain of multiplies and adds only. The
// fold depends on the sequence of keys alone and not on how they were cut
// into tiles, which gives the same independence of where the cache ends.
// Its tiles live in dynamic shared memory (86 KB at D 256 in f32).
#include "common.cuh"

namespace {

constexpr int kMaxG = 16;
constexpr int kMinThreads = 256;  // every FMA block stages with >= 8 warps
constexpr unsigned kFull = 0xffffffffu;

// One K or V tile (BK rows x W columns of T) held in registers: chunk c of
// the tile is row c / CPR, columns (c % CPR) * EPC ..; thread t holds chunks
// t, t + nthr, ... An int8 tile keeps each chunk's row scale beside it.
template <typename T, int W, int BK>
struct TileRegs {
  static constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
  static constexpr int CPR = W / EPC;          // chunks per row
  static constexpr int NCH = BK * CPR;         // chunks per tile
  static constexpr int CPT = (NCH + kMinThreads - 1) / kMinThreads;
  uint4 v[CPT];
  float s[CPT];
};

// Load the tile of rows base .. base+BK-1 of x [B, N, Hkv, W] for (b, h);
// rows outside [lo, hi) are not read and become zeros.
template <typename T, typename ST, int W, int BK>
__device__ __forceinline__ void tile_load(TileRegs<T, W, BK>& r,
                                          const T* __restrict__ x,
                                          const ST* __restrict__ sc, int b,
                                          int h, int N, int Hkv, int base,
                                          int lo, int hi, int tid, int nthr) {
  using R = TileRegs<T, W, BK>;
#pragma unroll
  for (int i = 0; i < R::CPT; ++i) {
    const int c = tid + i * nthr;
    const int p = base + c / R::CPR, col = (c % R::CPR) * R::EPC;
    r.v[i] = make_uint4(0u, 0u, 0u, 0u);
    r.s[i] = 0.f;
    if (c < R::NCH && p >= lo && p < hi) {
      const long row = (long)(b * N + p) * Hkv + h;
      r.v[i] = *reinterpret_cast<const uint4*>(x + row * W + col);
      if constexpr (std::is_same<T, int8_t>::value) r.s[i] = lbt_f(sc[row]);
    }
  }
}

// Store a loaded tile into shared memory as QT (int8 codes are multiplied
// by their row scale and rounded to QT, as the Pallas kernel's .astype).
template <typename QT, typename T, int W, int BK, int LD>
__device__ __forceinline__ void tile_store(const TileRegs<T, W, BK>& r,
                                           QT (*dst)[LD], int tid, int nthr) {
  using R = TileRegs<T, W, BK>;
#pragma unroll
  for (int i = 0; i < R::CPT; ++i) {
    const int c = tid + i * nthr;
    if (c >= R::NCH) continue;
    const int j = c / R::CPR, col = (c % R::CPR) * R::EPC;
    if constexpr (std::is_same<T, QT>::value) {
      *reinterpret_cast<uint4*>(&dst[j][col]) = r.v[i];
    } else {
      const int8_t* q = reinterpret_cast<const int8_t*>(&r.v[i]);
#pragma unroll
      for (int e = 0; e < R::EPC; ++e)
        dst[j][col + e] = lbt_from_f<QT>((float)q[e] * r.s[i]);
    }
  }
}

// the FMA kernel's keys a tile: 64 for 128-byte rows, 32 for wider ones
template <typename QT, int D>
constexpr int kFmaBK = (D * sizeof(QT) > 128) ? 32 : 64;

// its dynamic shared memory: K and V tiles, Q, each key's probability and
// rescale
template <typename QT, int D, int DV>
constexpr int fma_smem() {
  return kFmaBK<QT, D> * ((D + 16 / sizeof(QT)) + DV) * sizeof(QT) +
         kMaxG * (D + 2 * kFmaBK<QT, D>) * 4;
}

// q . k over D, in d order; k is a 16-byte aligned row of shared memory
template <typename QT, int D>
__device__ __forceinline__ float lbt_dot(const float* q, const QT* k) {
  constexpr int VE = 16 / sizeof(QT);
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += VE) {
    const uint4 raw = *reinterpret_cast<const uint4*>(k + d);
    const QT* kv = reinterpret_cast<const QT*>(&raw);
#pragma unroll
    for (int e = 0; e < VE; ++e) dot = fmaf(q[d + e], lbt_f(kv[e]), dot);
  }
  return dot;
}

template <typename QT, typename CT, typename ST, int D, int DV>
__global__ void __launch_bounds__(32 * kMaxG) flash_decode_fma_kernel(
    const QT* __restrict__ q, const CT* __restrict__ kc,
    const CT* __restrict__ vc, const ST* __restrict__ ks,
    const ST* __restrict__ vs, const QT* __restrict__ kr,
    const QT* __restrict__ vr, const int* __restrict__ meta,
    const int* __restrict__ win, const float* __restrict__ sinks,
    const float* __restrict__ alibi, float* __restrict__ out, int G, int C,
    int R, int Hkv, float scale, float softcap) {
  constexpr int BK = kFmaBK<QT, D>;
  constexpr int KPL = BK / 32;                   // keys per lane
  constexpr int LDK = D + 16 / sizeof(QT);       // padded: conflict-free
  constexpr int NA = (DV + 31) / 32;             // output dims per lane
  extern __shared__ __align__(16) unsigned char fsm[];
  QT(*Ks)[LDK] = reinterpret_cast<QT(*)[LDK]>(fsm);
  QT(*Vs)[DV] = reinterpret_cast<QT(*)[DV]>(&Ks[BK][0]);
  float(*qs)[D] = reinterpret_cast<float(*)[D]>(&Vs[BK][0]);
  float(*ps)[BK] = reinterpret_cast<float(*)[BK]>(&qs[kMaxG][0]);
  float(*as)[BK] = ps + kMaxG;  // ps: each key's exp(s - running max);
                                // as: the rescale it applies (1 = none)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, g = tid >> 5;

  const int cpos = meta[2 * b], nv = meta[2 * b + 1];
  const int window = win[0], chunk = win[1];
  const int cstart = cpos - nv + 1;  // first position owned by chain rows
  const float slope = alibi != nullptr && g < G ? alibi[h * G + g] : 0.f;

  for (int i = tid; i < G * D; i += nthr)
    qs[i / D][i % D] = lbt_f(q[(long)(b * Hkv + h) * G * D + i]);

  // lowest visible cache position (window / chunk floor)
  int lo = window > 0 ? max(cpos - window + 1, 0) : 0;
  if (chunk > 0) lo = max(lo, cpos / chunk * chunk);
  const int hi = min(cstart, C);

  float m = LBT_NEG_INF, l = 0.f, acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  // score the staged tile (keys kpos0 + j, j in [j_lo, j_hi)) for this
  // warp's query head and fold the keys into (m, l, acc) in order
  auto tile = [&](int kpos0, int j_lo, int j_hi, bool rows) {
    float sk[KPL];
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      const int j = lane + 32 * kk, kpos = kpos0 + j;
      bool ok = j >= j_lo && j < j_hi && lbt_pos_ok(kpos, cpos, window, chunk);
      if (rows) ok = ok && kpos >= 0;
      float s = LBT_NEG_INF;
      if (ok) {
        s = lbt_dot<QT, D>(&qs[g][0], &Ks[j][0]) * scale;
        if (alibi != nullptr) s += slope * (float)(kpos - cpos);
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      sk[kk] = s;
    }
    // running max through each key (inclusive, in key order)
    float mrun = m;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      float x = sk[kk];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x = fmaxf(x, y);
      }
      const float M = fmaxf(mrun, x);
      float Mprev = __shfl_up_sync(kFull, M, 1);
      if (lane == 0) Mprev = mrun;
      float a = 1.f, p = 0.f;
      if (sk[kk] != LBT_NEG_INF) {
        if (sk[kk] > Mprev) a = expf(Mprev - sk[kk]);
        p = expf(sk[kk] - M);
      }
      ps[g][lane + 32 * kk] = p;
      as[g][lane + 32 * kk] = a;
      mrun = __shfl_sync(kFull, M, 31);
    }
    m = mrun;
    __syncwarp();
    for (int j = j_lo; j < j_hi; ++j) {
      const float a = as[g][j], p = ps[g][j];
      l = __fadd_rn(__fmul_rn(l, a), p);
      const float pr = lbt_round<QT>(p);
#pragma unroll
      for (int i = 0; i < NA; ++i)
        if (DV % 32 == 0 || lane + 32 * i < DV)
          acc[i] = fmaf(pr, lbt_f(Vs[j][lane + 32 * i]), acc[i] * a);
    }
    __syncwarp();
  };

  // cache tiles over [lo, hi): positions outside are never read; the next
  // tile's loads are issued before this one is scored
  TileRegs<CT, D, BK> kreg;
  TileRegs<CT, DV, BK> vreg;
  int base = lo / BK * BK;
  if (base < hi) {
    tile_load(kreg, kc, ks, b, h, C, Hkv, base, lo, hi, tid, nthr);
    tile_load(vreg, vc, vs, b, h, C, Hkv, base, lo, hi, tid, nthr);
  }
  for (; base < hi; base += BK) {
    __syncthreads();
    tile_store<QT>(kreg, Ks, tid, nthr);
    tile_store<QT>(vreg, Vs, tid, nthr);
    __syncthreads();
    if (base + BK < hi) {
      tile_load(kreg, kc, ks, b, h, C, Hkv, base + BK, lo, hi, tid, nthr);
      tile_load(vreg, vc, vs, b, h, C, Hkv, base + BK, lo, hi, tid, nthr);
    }
    if (g < G) tile(base, max(lo - base, 0), min(hi - base, BK), false);
  }

  // chain rows 0 .. nv-1 (the current token's row is the last)
  const int nrow = min(nv, R);
  for (int rb = 0; rb < nrow; rb += BK) {
    TileRegs<QT, D, BK> krow;
    TileRegs<QT, DV, BK> vrow;
    tile_load(krow, kr, (const float*)nullptr, b, h, R, Hkv, rb, 0, nrow,
              tid, nthr);
    tile_load(vrow, vr, (const float*)nullptr, b, h, R, Hkv, rb, 0, nrow,
              tid, nthr);
    __syncthreads();
    tile_store<QT>(krow, Ks, tid, nthr);
    tile_store<QT>(vrow, Vs, tid, nthr);
    __syncthreads();
    if (g < G) tile(cstart + rb, 0, min(nrow - rb, BK), true);
  }

  if (g >= G) return;
  float f = 1.f, den = l;
  if (sinks != nullptr) {
    // attention sinks: a per-head logit joins the max and the denominator
    const float snk = sinks[h * G + g];
    const float m_fin = fmaxf(m, snk);
    f = expf(m - m_fin);
    den = l * f + expf(snk - m_fin);
  }
  const float inv = f / fmaxf(den, 1e-30f);
  float* o = out + ((long)(b * Hkv + h) * G + g) * DV;
#pragma unroll
  for (int i = 0; i < NA; ++i)
    if (DV % 32 == 0 || lane + 32 * i < DV) o[lane + 32 * i] = acc[i] * inv;
}

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps, 16 keys of every tile each
constexpr int BKEY = 64;          // keys per tile, from a multiple of 64
constexpr int kStages = 3;        // K/V tiles in the ring
constexpr int kMaxSplits = 64;

// one split's partial in the workspace: acc [kMaxG][DV], then (m, l) per
// query head
template <int DV>
constexpr int kPart = kMaxG * (DV + 2);

// Q in shared memory (read by ldmatrix) instead of registers, by width
template <int D>
constexpr bool kQShared = D > 128;

template <int D, int DV>
constexpr int mma_smem() {
  return (kStages * BKEY * ((D + 8) + (DV + 8)) +
          (kQShared<D> ? kMaxG * (D + 8) : 0)) * 2;
}

template <typename CT, typename ST, int D, int DV>
__global__ void __launch_bounds__(kMmaThreads) flash_decode_mma_kernel(
    const bf16* __restrict__ q, const CT* __restrict__ kc,
    const CT* __restrict__ vc, const ST* __restrict__ ks,
    const ST* __restrict__ vs, const bf16* __restrict__ kr,
    const bf16* __restrict__ vr, const int* __restrict__ meta,
    const int* __restrict__ win, const float* __restrict__ sinks,
    const float* __restrict__ alibi, float* __restrict__ ws,
    unsigned* __restrict__ cnt, float* __restrict__ out, int G, int C, int R,
    int Hkv, int L, float scale, float softcap) {
  constexpr int KLD = D + 8, VLD = DV + 8;  // 16-byte pad: ldmatrix rows
  constexpr int KT = D / 16;                // k-steps of S = Q K^T
  constexpr int NO = DV / 8;                // n8 tiles of O
  constexpr int P = kPart<DV>;
  constexpr bool QS = kQShared<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const Ks = reinterpret_cast<bf16*>(smem);   // [kStages][BKEY][KLD]
  bf16* const Vs = Ks + kStages * BKEY * KLD;       // [kStages][BKEY][VLD]
  bf16* const Qs = Vs + kStages * BKEY * VLD;       // [kMaxG][KLD] if QS
  __shared__ float wt[kMaxSplits][kMaxG];           // the final merge's
  __shared__ float fin[kMaxG];                      // weights and scales
  __shared__ int is_last;

  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int cpos = meta[2 * b], nv = meta[2 * b + 1];
  const int window = win[0], chunk = win[1];
  const int cstart = cpos - nv + 1;  // first position owned by chain rows

  // visible keys: [lo, cpos] (window / chunk floor to the causal edge);
  // the live splits are those that meet it, the same in every block
  int lo = window > 0 ? max(cpos - window + 1, 0) : 0;
  if (chunk > 0) lo = max(lo, cpos / chunk * chunk);
  const int s_lo = min(lo / L, S - 1), s_hi = min(max(cpos, 0) / L, S - 1);
  if (s < s_lo || s > s_hi) return;
  const int k_lo = max(lo, s * L);
  const int k_hi = s == S - 1 ? cpos : min(cpos, (s + 1) * L - 1);
  const int chi = min(cstart, C), nrow = min(nv, R);
  // a key of this split is read and seen iff its operand holds it: the
  // cache below the chain start, the chain's rows from it
  auto seen = [&](int kp) {
    return kp >= k_lo && kp <= k_hi &&
           (kp < cstart ? kp < chi : kp - cstart < nrow);
  };

  // Q as A fragments (rows: query heads, zero past G): a0/a2 row gq,
  // a1/a3 row gq + 8; k 2*tig (+8). In registers, or (QS) staged once in
  // shared memory
  uint32_t qf[QS ? 1 : KT][4];
  if constexpr (QS) {
    for (int e = tid; e < kMaxG * (D / 8); e += kMmaThreads) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < G)
        v = *reinterpret_cast<const uint4*>(
            q + ((long)(b * Hkv + h) * G + r) * D + c);
      *reinterpret_cast<uint4*>(Qs + r * KLD + c) = v;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = gq + 8 * (j & 1);
        const int col = kk * 16 + 2 * tig + (j >> 1) * 8;
        qf[kk][j] = r < G ? *reinterpret_cast<const uint32_t*>(
                                q + ((long)(b * Hkv + h) * G + r) * D + col)
                          : 0u;
      }
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {LBT_NEG_INF, LBT_NEG_INF}, l[2] = {0.f, 0.f};
  // scores in base 2: p = 2^(s*log2(e) - m), the scale folded in; the
  // ALiBi slopes of heads gq and gq + 8 in the same units
  constexpr float kLog2e = 1.4426950408889634f;
  const float sl = softcap > 0.f ? scale : scale * kLog2e;
  float slope[2] = {0.f, 0.f};
  if (alibi != nullptr)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = gq + 8 * i;
      slope[i] = (r < G ? alibi[h * G + r] : 0.f) *
                 (softcap > 0.f ? 1.f : kLog2e);
    }

  // tile t (absolute keys t*64 ..) -> stage i; keys not seen as zeros
  auto stage = [&](int t, int i) {
    bf16* K_ = Ks + i * BKEY * KLD;
    bf16* V_ = Vs + i * BKEY * VLD;
    auto one = [&](bf16* dst, const CT* cache, const ST* sc,
                   const bf16* rows, int W, int j, int c) {
      const int kp = t * BKEY + j;
      const bool ok = seen(kp);
      if (kp < cstart) {
        const long row = (long)(b * C + (ok ? kp : 0)) * Hkv + h;
        if constexpr (std::is_same<CT, bf16>::value) {
          lbt_cp16(dst, cache + row * W + c, ok);
        } else {
          *reinterpret_cast<uint4*>(dst) =
              ok ? lbt_deq8(cache + row * W + c, sc[row])
                 : make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        const int r = ok ? kp - cstart : 0;
        lbt_cp16(dst, rows + ((long)(b * R + r) * Hkv + h) * W + c, ok);
      }
    };
    for (int e = tid; e < BKEY * (D / 8); e += kMmaThreads) {
      const int j = e / (D / 8), c = (e % (D / 8)) * 8;
      one(K_ + j * KLD + c, kc, ks, kr, D, j, c);
    }
    for (int e = tid; e < BKEY * (DV / 8); e += kMmaThreads) {
      const int j = e / (DV / 8), c = (e % (DV / 8)) * 8;
      one(V_ + j * VLD + c, vc, vs, vr, DV, j, c);
    }
  };

  // this warp's 16 keys of tile t (stage i): a part no key of which is
  // seen leaves the state as it is and is skipped
  auto compute = [&](int t, int i) {
    const int kp0 = t * BKEY + warp * 16;
    if (kp0 > k_hi || kp0 + 15 < k_lo) return;
    const bf16* K_ = Ks + (i * BKEY + warp * 16) * KLD;
    const bf16* V_ = Vs + (i * BKEY + warp * 16) * VLD;
    // S = Q K^T: K rows (keys) by ldmatrix, matrices (keys 0-7 | 8-15) x
    // (d 0-7 | 8-15)
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4];
      if constexpr (QS) {
        lbt_ldsm4(qa, Qs + (lane & 15) * KLD + kk * 16 + (lane >> 4) * 8);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) qa[j] = qf[kk][j];
      }
      uint32_t r[4];
      lbt_ldsm4(r, K_ + ((lane & 7) + (lane >> 4) * 8) * KLD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      lbt_mma_bf16(sc[0], qa, b0);
      lbt_mma_bf16(sc[1], qa, b1);
    }
    // ALiBi, softcap, mask, online softmax (c0, c1: head gq; c2, c3: head
    // gq + 8; keys 2*tig, 2*tig + 1 of each n8 tile)
    float tmax[2] = {LBT_NEG_INF, LBT_NEG_INF};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kp0 + n * 8 + 2 * tig + (e & 1);
        float v = sc[n][e] * sl;
        if (alibi != nullptr) v += slope[e >> 1] * (float)(kp - cpos);
        if (softcap > 0.f) v = softcap * tanhf(v / softcap) * kLog2e;
        v = seen(kp) ? v : -INFINITY;
        sc[n][e] = v;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], v);
      }
    float alpha[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      tmax[i2] = fmaxf(tmax[i2], __shfl_xor_sync(kFull, tmax[i2], 1));
      tmax[i2] = fmaxf(tmax[i2], __shfl_xor_sync(kFull, tmax[i2], 2));
      const float mn = fmaxf(m[i2], tmax[i2]);
      alpha[i2] = exp2f(m[i2] - mn);
      m[i2] = mn;
      l[i2] *= alpha[i2];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[n][e] - m[e >> 1]);  // masked: 2^-inf = 0
        l[e >> 1] += p;
        sc[n][e] = p;
      }
    // O += P V: P (bf16) from registers as A, V rows by ldmatrix.trans,
    // matrices (keys 0-7 | 8-15) x (dv 0-7 | 8-15)
    const uint32_t pa[4] = {lbt_pack_bf16(sc[0][0], sc[0][1]),
                            lbt_pack_bf16(sc[0][2], sc[0][3]),
                            lbt_pack_bf16(sc[1][0], sc[1][1]),
                            lbt_pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t r[4];
      lbt_ldsm4_t(r, V_ + ((lane & 7) + ((lane >> 3) & 1) * 8) * VLD +
                         np * 16 + (lane >> 4) * 8);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      lbt_mma_bf16(o[2 * np], pa, b0);
      lbt_mma_bf16(o[2 * np + 1], pa, b1);
    }
  };

  // the ring: stage (it - 1) % kStages is refilled only after the barrier
  // that follows every warp's compute of tile it - 1 (the first barrier
  // also publishes a shared Q)
  const int tlo = k_lo / BKEY, thi = k_hi >= k_lo ? k_hi / BKEY + 1 : tlo;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (tlo + i < thi) stage(tlo + i, i);
    lbt_cp_commit();
  }
  for (int t = tlo; t < thi; ++t) {
    const int it = t - tlo;
    lbt_cp_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < thi)
      stage(t + kStages - 1, (it + kStages - 1) % kStages);
    lbt_cp_commit();
    compute(t, it % kStages);
  }
  lbt_cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }

  // the warps' states through shared memory (the ring is done with),
  // merged in warp order into this split's partial
  __syncthreads();
  float* const pm = reinterpret_cast<float*>(smem);   // [4][kMaxG]
  float* const pl = pm + 4 * kMaxG;                   // [4][kMaxG]
  float* const po = pl + 4 * kMaxG;                   // [4][kMaxG][DV]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * kMaxG + gq + 8 * i;
    if (tig == 0) {
      pm[r] = m[i];
      pl[r] = l[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(po + r * DV + n * 8 + 2 * tig) =
          make_float2(o[n][2 * i], o[n][2 * i + 1]);
  }
  __syncthreads();
  float* const part = ws + ((long)(b * Hkv + h) * S + s) * P;
  for (int e = tid; e < G * DV; e += kMmaThreads) {
    const int g = e / DV, d = e % DV;
    float M = LBT_NEG_INF, acc = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, pm[w * kMaxG + g]);
#pragma unroll
    for (int w = 0; w < 4; ++w)
      acc += po[(w * kMaxG + g) * DV + d] * exp2f(pm[w * kMaxG + g] - M);
    part[g * DV + d] = acc;
  }
  for (int g = tid; g < G; g += kMmaThreads) {
    float M = LBT_NEG_INF, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, pm[w * kMaxG + g]);
#pragma unroll
    for (int w = 0; w < 4; ++w)
      lsum += pl[w * kMaxG + g] * exp2f(pm[w * kMaxG + g] - M);
    part[kMaxG * DV + 2 * g] = M;
    part[kMaxG * DV + 2 * g + 1] = lsum;
  }

  // the last live split of this (slot, KV head) merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned* c = cnt + b * Hkv + h;
    const bool last = atomicAdd(c, 1u) == (unsigned)(s_hi - s_lo);
    if (last) atomicExch(c, 0u);
    is_last = last;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* const parts = ws + (long)(b * Hkv + h) * S * P;
  for (int g = tid; g < G; g += kMmaThreads) {
    float M = LBT_NEG_INF, den = 0.f;
    for (int j = s_lo; j <= s_hi; ++j)
      M = fmaxf(M, __ldcg(parts + j * P + kMaxG * DV + 2 * g));
    for (int j = s_lo; j <= s_hi; ++j) {
      const float w =
          exp2f(__ldcg(parts + j * P + kMaxG * DV + 2 * g) - M);
      wt[j - s_lo][g] = w;
      den += __ldcg(parts + j * P + kMaxG * DV + 2 * g + 1) * w;
    }
    float f = 1.f;
    if (sinks != nullptr) {
      // attention sinks: a per-head logit joins the max and the denominator
      const float snk = sinks[h * G + g] * kLog2e;
      const float m_fin = fmaxf(M, snk);
      f = exp2f(M - m_fin);
      den = den * f + exp2f(snk - m_fin);
    }
    fin[g] = f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < G * DV; e += kMmaThreads) {
    const int g = e / DV, d = e % DV;
    float acc = 0.f;
    for (int j = s_lo; j <= s_hi; ++j)
      acc += __ldcg(parts + j * P + g * DV + d) * wt[j - s_lo][g];
    out[((long)(b * Hkv + h) * G + g) * DV + d] = acc * fin[g];
  }
}

struct Call {
  const void *q, *kc, *vc, *ks, *vs, *kr, *vr, *meta, *win, *sinks, *alibi;
  void *ws, *cnt, *out;
  int B, Hkv, G, C, R, L, S;
  float scale, softcap;
  cudaStream_t st;
};

template <typename QT, typename CT, typename ST, int D, int DV>
int launch(const Call& a) {
  if constexpr (std::is_same<QT, bf16>::value) {
    auto kern = flash_decode_mma_kernel<CT, ST, D, DV>;
    constexpr int smem = mma_smem<D, DV>();
    static_assert(smem >= (8 * kMaxG + 4 * kMaxG * DV) * 4,
                  "the warps' merge fits in the ring");
    static_assert(smem + (kMaxSplits + 1) * kMaxG * 4 + 16 <= 227 * 1024,
                  "a block's shared memory");
    if (a.S < 1 || a.S > kMaxSplits || a.L < BKEY || a.L % BKEY ||
        !a.ws || !a.cnt)
      return LBT_UNSUPPORTED;
    static int allowed = 0;
    if (!allowed) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      allowed = 1;
    }
    kern<<<dim3(a.Hkv, a.B, a.S), kMmaThreads, smem, a.st>>>(
        (const bf16*)a.q, (const CT*)a.kc, (const CT*)a.vc, (const ST*)a.ks,
        (const ST*)a.vs, (const bf16*)a.kr, (const bf16*)a.vr,
        (const int*)a.meta, (const int*)a.win, (const float*)a.sinks,
        (const float*)a.alibi, (float*)a.ws, (unsigned*)a.cnt, (float*)a.out,
        a.G, a.C, a.R, a.Hkv, a.L, a.scale, a.softcap);
  } else {
    auto kern = flash_decode_fma_kernel<QT, CT, ST, D, DV>;
    constexpr int smem = fma_smem<QT, D, DV>();
    static int allowed = 0;
    if (!allowed) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      allowed = 1;
    }
    const int threads = 32 * a.G > kMinThreads ? 32 * a.G : kMinThreads;
    kern<<<dim3(a.Hkv, a.B), threads, smem, a.st>>>(
        (const QT*)a.q, (const CT*)a.kc, (const CT*)a.vc, (const ST*)a.ks,
        (const ST*)a.vs, (const QT*)a.kr, (const QT*)a.vr, (const int*)a.meta,
        (const int*)a.win, (const float*)a.sinks, (const float*)a.alibi,
        (float*)a.out, a.G, a.C, a.R, a.Hkv, a.scale, a.softcap);
  }
  return (int)cudaGetLastError();
}

template <int D, int DV>
int dispatch(int qd, int cd, int sd, const Call& a) {
  if (qd == LBT_BF16 && cd == LBT_BF16)
    return launch<bf16, bf16, float, D, DV>(a);
  if (qd == LBT_F32 && cd == LBT_F32)
    return launch<float, float, float, D, DV>(a);
  if (qd == LBT_BF16 && cd == LBT_I8 && sd == LBT_BF16)
    return launch<bf16, int8_t, bf16, D, DV>(a);
  if (qd == LBT_BF16 && cd == LBT_I8 && sd == LBT_F32)
    return launch<bf16, int8_t, float, D, DV>(a);
  if (qd == LBT_F32 && cd == LBT_I8 && sd == LBT_BF16)
    return launch<float, int8_t, bf16, D, DV>(a);
  if (qd == LBT_F32 && cd == LBT_I8 && sd == LBT_F32)
    return launch<float, int8_t, float, D, DV>(a);
  return LBT_UNSUPPORTED;
}

}  // namespace

// q [B,Hkv,G,D]; kc/vc [B,C,Hkv,D|DV]; ks/vs [B,C,Hkv] or null;
// kr/vr [B,R,Hkv,D|DV] in q's dtype; meta [B,2] (cpos, nv); win [2];
// sinks [Hkv,G] f32 or null; alibi [Hkv,G] f32 slopes or null; out
// [B,Hkv,G,DV] f32; (D, DV) one of (64, 64), (80, 80), (96, 96), (128,
// 128), (256, 256), (192, 128) and (96, 64). For a bf16 q: S splits of L
// positions (L a multiple of 64, 1 <= S <= 64), ws f32 [B,Hkv,S,16*(DV+2)]
// scratch and counters, B*Hkv unsigned ints that are 0 before the call and
// are 0 again after it (both unused for an f32 q). All contiguous, all on
// the device, the K/V operands 16-byte aligned. Returns cudaGetLastError()
// after the launch, or -1 for a configuration no instantiation covers.
extern "C" int lbt_flash_decode(int q_dtype, int kv_dtype, int scale_dtype,
                                int D, int DV, const void* q, const void* kc,
                                const void* vc, const void* ks, const void* vs,
                                const void* kr, const void* vr,
                                const void* meta, const void* win,
                                const void* sinks, const void* alibi,
                                void* ws, void* counters, void* out, int B,
                                int Hkv, int G, int C, int R, int L, int S,
                                float scale, float softcap, void* stream) {
  if (G < 1 || G > kMaxG) return LBT_UNSUPPORTED;
  const Call a{q,     kc,       vc,  ks, vs,  kr, vr, meta, win, sinks,
               alibi, ws,       counters, out, B, Hkv, G, C, R,    L,
               S,     scale,    softcap,  (cudaStream_t)stream};
#define LBT_WIDTHS(W, WV) \
  if (D == W && DV == WV)  \
    return dispatch<W, WV>(q_dtype, kv_dtype, scale_dtype, a);
  LBT_WIDTHS(64, 64)
  LBT_WIDTHS(80, 80)
  LBT_WIDTHS(96, 96)
  LBT_WIDTHS(128, 128)
  LBT_WIDTHS(256, 256)
  LBT_WIDTHS(192, 128)
  LBT_WIDTHS(96, 64)
#undef LBT_WIDTHS
  return LBT_UNSUPPORTED;
}
