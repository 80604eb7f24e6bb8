// Batched prefill attention over a read-only cache plus the chunk's rows.
//
// A meta row of five columns names the cache row (slot) that batch row b
// reads, so a pass over one slot reads it in place from the whole cache
// and one captured program serves every slot; of four, batch row b reads
// cache row b.
//
// Replaces the Pallas kernel _flash_batched_kernel / flash_prefill_batched
// (llama_box_tpu/ops/flash_prefill.py:75, :198): row r of slot b sits at
// position pos0 + r and attends cache positions < pos0 and the chunk's own
// rows, under the causal, sliding-window and aligned-chunk masks, or any
// position in the bidirectional span [st, en); rows >= n_valid are dead.
//
// What bounds it: operations. A 512-row chunk does ~G * T / 2 multiply-adds
// per byte of K/V it reads, above the card's ridge, so the floor is the
// tensor-core rate.
//
// Which kernel: a bf16 q (the served path; bf16 or int8 cache) takes
// flash_prefill_mma_kernel, on the tensor cores. An f32 q (f32 or int8
// cache) takes flash_prefill_fma_kernel, f32 FMAs on the CUDA cores: bf16
// and TF32 tensor cores cannot hold an f32 q to the f32 tolerance. The
// choice is made by dtype in lbt_flash_prefill, before any launch.
//
// Both kernels: one block per (slot, KV head, tile of BQ query positions)
// with all G query heads of the GQA group in the block, block row r being
// head r / BQ at position qt * BQ + r % BQ (G * BQ <= 128 rows), so every
// K/V tile is staged in shared memory once and read by all G heads. The
// TPU kernel carried the softmax state across its sequential grid axis;
// here each row carries (m, l, acc) in registers through one loop over the
// key tiles. Keys below the window/chunk floor of the block's first row,
// and rows past its causal edge (or past n_valid, with a bidirectional
// span), are never read: the loop bounds skip them and partly visible
// tiles are staged as zeros there, so a NaN in a never-read position
// cannot reach the output through a 0 * NaN product.
//
// flash_prefill_mma_kernel (FlashAttention-2 style): 8 warps of 16 rows.
// Q fragments stay in registers; K/V tiles of 64 keys arrive by cp.async
// (int8 caches: codes times their scale, rounded to bf16 as kv_dequant
// does, through registers) into a 3-stage ring, so two tiles are in flight
// while one is computed. S = Q K^T and O += P V run as mma.sync.m16n8k16
// (bf16 x bf16 -> f32) from ldmatrix fragments (.trans for V); the masks
// (skipped on a tile all 16 rows of a warp see whole), softcap and the
// online softmax (in base 2, the scale times log2(e) folded into one
// multiply) are applied per element in registers, and
// P is rounded to bf16 and fed from registers as the A operand of P V, the
// rounding point of the plain version. Tiles are aligned to absolute key
// positions (multiples of 64 from 0), and the tile that straddles pos0
// takes cache keys and row keys together: a row sees the same keys in the
// same tile columns and the same mma order whether its prefix was cached or
// prefilled in the same pass, so a cold prefill and a cached-prefix one
// give the same bits (a tile a row cannot see leaves its state unchanged:
// alpha = 1, p = 0).
//
// At D 256 the Q fragments (64 registers a thread beside the 128 of the O
// accumulator) move to shared memory and are read by ldmatrix at every
// k-step, and the ring has 2 stages: 2 x 64 keys x 528 bytes of K and V
// plus 128 rows of Q is 198 KB of the 227 KB a block may hold. Rows of 80
// and 96 elements are padded by 16 bytes as the others are (176 and 208
// bytes: eight ldmatrix rows fall in distinct banks).
//
// K and V may differ in width (multi-head latent attention: D 192 / DV 128,
// D 96 / DV 64): S = Q K^T runs D / 16 k-steps over K rows of D, O = P V
// DV / 8 n8 tiles over V rows of DV, each padded by its own 16 bytes. The
// choices that go by width go by D, the K width: at D 192 Q sits in shared
// memory beside a 2-stage ring, as at D 256 (2 x 64 x (400 + 272) bytes
// plus 128 rows of Q, 134 KB).
//
// flash_prefill_fma_kernel: one thread per row, each dot product as D f32
// FMAs from 32-key shared tiles (16 above D 128, under the 48 KB static
// limit), keys folded one at a time in position order (lbt_softmax_step),
// which gives the same independence of where the cache ends.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // flash_prefill_fma_kernel: one row a thread

template <typename QT, typename CT, typename ST, int D, int DV>
__global__ void __launch_bounds__(kThreads) flash_prefill_fma_kernel(
    const QT* __restrict__ q, const CT* __restrict__ kc,
    const CT* __restrict__ vc, const ST* __restrict__ ks,
    const ST* __restrict__ vs, const QT* __restrict__ kr,
    const QT* __restrict__ vr, const int* __restrict__ meta,
    const int* __restrict__ win, const float* __restrict__ sinks,
    const float* __restrict__ alibi, float* __restrict__ out, int G, int T,
    int C, int Hkv, int BQ, int MC, float scale, float softcap) {
  constexpr int BK = D > 128 ? 16 : 32;  // keys per shared-memory tile
  __shared__ QT Ks[BK][D];
  __shared__ QT Vs[BK][DV];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = tid / BQ, t = qt * BQ + tid % BQ;
  const bool live = g < G && t < T;

  const int pos0 = meta[MC * b], nval = meta[MC * b + 1];
  const int st = meta[MC * b + 2], en = meta[MC * b + 3];
  const int cb = MC > 4 ? meta[MC * b + 4] : b;  // the cache row read
  const int window = win[0], chunk = win[1];
  const int qpos = pos0 + t;
  const float slope = alibi != nullptr && live ? alibi[h * G + g] : 0.f;

  float qr[D], acc[DV];
  const QT* qp = q + ((long)((b * Hkv + h) * G + g) * T + t) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = live ? lbt_f(qp[d]) : 0.f;
#pragma unroll
  for (int d = 0; d < DV; ++d) acc[d] = 0.f;
  float m = LBT_NEG_INF, l = 0.f;

  // lowest cache position any row of this block can see (window and chunk
  // floors; the bidirectional span may reach below them)
  const int qmin = pos0 + qt * BQ;
  int lo = window > 0 ? qmin - window + 1 : 0;
  if (chunk > 0) lo = max(lo, qmin / chunk * chunk);
  if (en > st) lo = min(lo, st);
  lo = max(lo, 0);
  const int hi = min(pos0, C);

  auto visible = [&](int kpos) {
    return lbt_pos_ok(kpos, qpos, window, chunk) || (kpos >= st && kpos < en);
  };
  // fold the staged tile's keys kpos0 + j (j_lo <= j < j_hi) into this row
  auto tile = [&](int kpos0, int j_lo, int j_hi) {
    if (!live) return;
    for (int j = j_lo; j < j_hi; ++j) {
      if (!visible(kpos0 + j)) continue;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qr[d] * lbt_f(Ks[j][d]);
      float s = dot * scale;
      if (alibi != nullptr) s += slope * (float)(kpos0 + j - qpos);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const float p = lbt_softmax_step<QT, DV>(s, m, l, acc);
#pragma unroll
      for (int d = 0; d < DV; ++d) acc[d] += p * lbt_f(Vs[j][d]);
    }
  };

  // cache tiles over [lo, pos0)
  for (int base = lo / BK * BK; base < hi; base += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += kThreads) {
      const int j = i / D, d = i % D, c = base + j;
      float x = 0.f;
      if (c >= lo && c < hi)
        x = lbt_kv<QT>(kc, ks, ((long)(cb * C + c) * Hkv + h) * D + d,
                       (long)(cb * C + c) * Hkv + h);
      Ks[j][d] = lbt_from_f<QT>(x);
    }
    for (int i = tid; i < BK * DV; i += kThreads) {
      const int j = i / DV, d = i % DV, c = base + j;
      float x = 0.f;
      if (c >= lo && c < hi)
        x = lbt_kv<QT>(vc, vs, ((long)(cb * C + c) * Hkv + h) * DV + d,
                       (long)(cb * C + c) * Hkv + h);
      Vs[j][d] = lbt_from_f<QT>(x);
    }
    __syncthreads();
    tile(base, max(lo - base, 0), min(hi - base, BK));
  }

  // the chunk's rows: up to the causal edge of this block, or all valid
  // rows when a bidirectional span may expose later ones
  int rhi = en > st ? nval : min(nval, (qt + 1) * BQ);
  rhi = min(rhi, T);
  for (int base = 0; base < rhi; base += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += kThreads) {
      const int j = i / D, d = i % D, r = base + j;
      Ks[j][d] = r < rhi ? kr[((long)(b * T + r) * Hkv + h) * D + d]
                         : lbt_from_f<QT>(0.f);
    }
    for (int i = tid; i < BK * DV; i += kThreads) {
      const int j = i / DV, d = i % DV, r = base + j;
      Vs[j][d] = r < rhi ? vr[((long)(b * T + r) * Hkv + h) * DV + d]
                         : lbt_from_f<QT>(0.f);
    }
    __syncthreads();
    tile(pos0 + base, 0, min(rhi - base, BK));
  }

  if (!live) return;
  float f = 1.f, den = l;
  if (sinks != nullptr) {
    const float snk = sinks[h * G + g];
    const float m_fin = fmaxf(m, snk);
    f = expf(m - m_fin);
    den = l * f + expf(snk - m_fin);
  }
  const float inv = f / fmaxf(den, 1e-30f);
  float* o = out + ((long)((b * Hkv + h) * G + g) * T + t) * DV;
#pragma unroll
  for (int d = 0; d < DV; ++d) o[d] = acc[d] * inv;
}

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 256;  // 8 warps x 16 rows
constexpr int kRows = 128;        // rows (head, position) per block
constexpr int BKEY = 64;          // keys per tile
constexpr int kStages = 3;        // K/V tiles in the ring

// Q in shared memory (read by ldmatrix) instead of registers, and the
// ring's depth, by head width
template <int D>
constexpr bool kQShared = D > 128;
template <int D>
constexpr int kStagesFor = D > 128 ? 2 : kStages;

template <typename CT, typename ST, int D, int DV>
constexpr int mma_smem() {
  return (kStagesFor<D> * BKEY * ((D + 8) + (DV + 8)) +
          (kQShared<D> ? kRows * (D + 8) : 0)) * 2;
}

// AL: ALiBi slopes are given (a template parameter, so the kernel without
// them keeps its registers: at D 64 two blocks an SM leave 128 a thread)
template <typename CT, typename ST, int D, int DV, bool AL>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 2 : 1)
    flash_prefill_mma_kernel(const bf16* __restrict__ q,
                             const CT* __restrict__ kc,
                             const CT* __restrict__ vc,
                             const ST* __restrict__ ks,
                             const ST* __restrict__ vs,
                             const bf16* __restrict__ kr,
                             const bf16* __restrict__ vr,
                             const int* __restrict__ meta,
                             const int* __restrict__ win,
                             const float* __restrict__ sinks,
                             const float* __restrict__ alibi,
                             float* __restrict__ out, int G, int T, int C,
                             int Hkv, int BQ, int MC, float scale,
                             float softcap) {
  constexpr int KLD = D + 8, VLD = DV + 8;  // 16-byte pad: ldmatrix rows
  constexpr int KT = D / 16;                // k-steps of S = Q K^T
  constexpr int NS = BKEY / 8;              // n8 tiles of S
  constexpr int NO = DV / 8;                // n8 tiles of O
  constexpr int NST = kStagesFor<D>;        // K/V tiles in the ring
  constexpr bool QS = kQShared<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const Ks = reinterpret_cast<bf16*>(smem);   // [NST][BKEY][KLD]
  bf16* const Vs = Ks + NST * BKEY * KLD;           // [NST][BKEY][VLD]
  bf16* const Qs = Vs + NST * BKEY * VLD;           // [kRows][KLD] if QS

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int pos0 = meta[MC * b], nval = meta[MC * b + 1];
  const int st = meta[MC * b + 2], en = meta[MC * b + 3];
  const int cb = MC > 4 ? meta[MC * b + 4] : b;  // the cache row read
  const int window = win[0], chunk = win[1];

  // this thread's rows of the m16 tiles: warp * 16 + gq (+ 8)
  int rg[2], rt[2], qpos[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gq + 8 * i;
    rg[i] = r / BQ;
    rt[i] = qt * BQ + r % BQ;
    live[i] = rg[i] < G && rt[i] < T;
    qpos[i] = pos0 + rt[i];
  }
  // ALiBi slopes of this thread's two rows, in the units of the scores
  // below (base 2 unless the softcap comes first)
  constexpr float kLog2e = 1.4426950408889634f;
  float slope[2] = {0.f, 0.f};
  if constexpr (AL)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      slope[i] = (live[i] ? alibi[h * G + rg[i]] : 0.f) *
                 (softcap > 0.f ? 1.f : kLog2e);
  // Q as A fragments: a0/a2 row gq, a1/a3 row gq + 8; k 2*tig (+8). In
  // registers, or (QS) staged once in shared memory, zero for dead rows
  uint32_t qf[QS ? 1 : KT][4];
  if constexpr (QS) {
    for (int e = tid; e < kRows * (D / 8); e += kMmaThreads) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const int g = r / BQ, t = qt * BQ + r % BQ;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (g < G && t < T)
        v = *reinterpret_cast<const uint4*>(
            q + ((long)((b * Hkv + h) * G + g) * T + t) * D + c);
      *reinterpret_cast<uint4*>(Qs + r * KLD + c) = v;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = j & 1, col = kk * 16 + 2 * tig + (j >> 1) * 8;
        qf[kk][j] = live[i] ? *reinterpret_cast<const uint32_t*>(
                                  q + ((long)((b * Hkv + h) * G + rg[i]) * T +
                                       rt[i]) * D + col)
                            : 0u;
      }
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {LBT_NEG_INF, LBT_NEG_INF}, l[2] = {0.f, 0.f};

  // keys [lo, pos0) of the cache and rows [0, rhi) may be read
  const int qmin = pos0 + qt * BQ;
  int lo = window > 0 ? qmin - window + 1 : 0;
  if (chunk > 0) lo = max(lo, qmin / chunk * chunk);
  if (en > st) lo = min(lo, st);
  lo = max(lo, 0);
  const int hi = min(pos0, C);
  int rhi = en > st ? nval : min(nval, (qt + 1) * BQ);
  rhi = min(rhi, T);
  const int tlo = lo / BKEY, thi = (pos0 + rhi + BKEY - 1) / BKEY;
  auto readable = [&](int kp) {
    return kp < pos0 ? (kp >= lo && kp < hi) : (kp - pos0 < rhi);
  };
  // a tile every row of this warp sees whole needs no mask: readable keys
  // only, all at or below the warp's first position, no window or chunk
  const int wqmin = __reduce_min_sync(0xffffffffu, min(qpos[0], qpos[1]));
  auto whole = [&](int t) {
    const int k0 = t * BKEY, k1 = k0 + BKEY;
    return window <= 0 && chunk <= 0 && k1 - 1 <= wqmin && k0 >= lo &&
           (k1 <= hi || ((hi == pos0 || k0 >= pos0) && k1 <= pos0 + rhi));
  };
  // scores in base 2: p = 2^(s*log2(e) - m), the scale folded in
  const float sl = softcap > 0.f ? scale : scale * kLog2e;

  // tile t (absolute keys t*64 ..) -> stage i; unreadable keys as zeros
  auto stage = [&](int t, int i) {
    bf16* K_ = Ks + i * BKEY * KLD;
    bf16* V_ = Vs + i * BKEY * VLD;
    auto one = [&](bf16* dst, const CT* cache, const ST* sc,
                   const bf16* rows, int W, int j, int c) {
      const int kp = t * BKEY + j;
      const bool ok = readable(kp);
      if (kp < pos0) {
        const long row = (long)(cb * C + (ok ? kp : 0)) * Hkv + h;
        if constexpr (std::is_same<CT, bf16>::value) {
          lbt_cp16(dst, cache + row * W + c, ok);
        } else {
          *reinterpret_cast<uint4*>(dst) =
              ok ? lbt_deq8(cache + row * W + c, sc[row])
                 : make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        const int r = ok ? kp - pos0 : 0;
        lbt_cp16(dst, rows + ((long)(b * T + r) * Hkv + h) * W + c, ok);
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

  auto compute = [&](int t, int i) {
    const bf16* K_ = Ks + i * BKEY * KLD;
    const bf16* V_ = Vs + i * BKEY * VLD;
    // S = Q K^T: K rows (keys) by ldmatrix, matrices (keys 0-7 | 8-15) x
    // (d 0-7 | 8-15) of a pair of n8 tiles
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t qa[4];
      if constexpr (QS) {
        lbt_ldsm4(qa, Qs + (warp * 16 + (lane & 15)) * KLD + kk * 16 +
                          (lane >> 4) * 8);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) qa[j] = qf[kk][j];
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        lbt_ldsm4(r, K_ + (np * 16 + (lane & 7) + (lane >> 4) * 8) * KLD +
                         kk * 16 + ((lane >> 3) & 1) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        lbt_mma_bf16(sc[2 * np], qa, b0);
        lbt_mma_bf16(sc[2 * np + 1], qa, b1);
      }
    }
    // ALiBi, softcap, masks (not on a tile the whole warp sees), online
    // softmax
    // (c0, c1: row gq; c2, c3: row gq + 8; columns 2*tig, 2*tig + 1 of
    // each n8 tile)
    const bool all = whole(t);
    float tmax[2] = {LBT_NEG_INF, LBT_NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = e >> 1, kp = t * BKEY + n * 8 + 2 * tig + (e & 1);
        float v = sc[n][e] * sl;
        if constexpr (AL) v += slope[i2] * (float)(kp - qpos[i2]);
        if (softcap > 0.f) v = softcap * tanhf(v / softcap) * kLog2e;
        if (!all) {
          const bool vis =
              readable(kp) && (lbt_pos_ok(kp, qpos[i2], window, chunk) ||
                               (kp >= st && kp < en));
          v = vis ? v : -INFINITY;
        }
        sc[n][e] = v;
        tmax[i2] = fmaxf(tmax[i2], v);
      }
    float alpha[2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      tmax[i2] = fmaxf(tmax[i2], __shfl_xor_sync(0xffffffffu, tmax[i2], 1));
      tmax[i2] = fmaxf(tmax[i2], __shfl_xor_sync(0xffffffffu, tmax[i2], 2));
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
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[n][e] - m[e >> 1]);  // masked: 2^-inf = 0
        l[e >> 1] += p;
        sc[n][e] = p;
      }
    // O += P V: P (bf16) from registers as A, V rows by ldmatrix.trans,
    // matrices (keys 0-7 | 8-15) x (dv 0-7 | 8-15)
#pragma unroll
    for (int j = 0; j < BKEY / 16; ++j) {
      const uint32_t pa[4] = {
          lbt_pack_bf16(sc[2 * j][0], sc[2 * j][1]),
          lbt_pack_bf16(sc[2 * j][2], sc[2 * j][3]),
          lbt_pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
          lbt_pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t r[4];
        lbt_ldsm4_t(r, V_ + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               VLD + np * 16 + (lane >> 4) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        lbt_mma_bf16(o[2 * np], pa, b0);
        lbt_mma_bf16(o[2 * np + 1], pa, b1);
      }
    }
  };

  // the ring: stage (it - 1) % NST is refilled only after the barrier
  // that follows every warp's compute of tile it - 1 (the first barrier
  // also publishes a shared Q)
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (tlo + i < thi) stage(tlo + i, i);
    lbt_cp_commit();
  }
  for (int t = tlo; t < thi; ++t) {
    const int it = t - tlo;
    lbt_cp_wait<NST - 2>();
    __syncthreads();
    if (t + NST - 1 < thi) stage(t + NST - 1, (it + NST - 1) % NST);
    lbt_cp_commit();
    compute(t, it % NST);
  }
  lbt_cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    float f = 1.f, den = l[i];
    if (sinks != nullptr) {
      const float snk = sinks[h * G + rg[i]] * kLog2e;
      const float m_fin = fmaxf(m[i], snk);
      f = exp2f(m[i] - m_fin);
      den = l[i] * f + exp2f(snk - m_fin);
    }
    const float inv = f / fmaxf(den, 1e-30f);
    float* op = out + ((long)((b * Hkv + h) * G + rg[i]) * T + rt[i]) * DV;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(op + n * 8 + 2 * tig) =
          make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <typename QT, typename CT, typename ST, int D, int DV>
int launch(const void* q, const void* kc, const void* vc, const void* ks,
           const void* vs, const void* kr, const void* vr, const void* meta,
           const void* win, const void* sinks, const void* alibi, void* out,
           int B, int Hkv, int G, int T, int C, int MC, float scale,
           float softcap, cudaStream_t stream) {
  if constexpr (std::is_same<QT, bf16>::value) {
    auto kern = alibi != nullptr
                    ? flash_prefill_mma_kernel<CT, ST, D, DV, true>
                    : flash_prefill_mma_kernel<CT, ST, D, DV, false>;
    constexpr int smem = mma_smem<CT, ST, D, DV>();
    static_assert(smem <= 227 * 1024, "a block's shared memory");
    static int allowed[2] = {0, 0};
    if (!allowed[alibi != nullptr]) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      allowed[alibi != nullptr] = 1;
    }
    const int BQ = kRows / G;
    dim3 grid((T + BQ - 1) / BQ, Hkv, B);
    kern<<<grid, kMmaThreads, smem, stream>>>(
        (const bf16*)q, (const CT*)kc, (const CT*)vc, (const ST*)ks,
        (const ST*)vs, (const bf16*)kr, (const bf16*)vr, (const int*)meta,
        (const int*)win, (const float*)sinks, (const float*)alibi,
        (float*)out, G, T, C, Hkv, BQ, MC, scale, softcap);
  } else {
    const int BQ = kThreads / G;
    dim3 grid((T + BQ - 1) / BQ, Hkv, B);
    flash_prefill_fma_kernel<QT, CT, ST, D, DV><<<grid, kThreads, 0, stream>>>(
        (const QT*)q, (const CT*)kc, (const CT*)vc, (const ST*)ks,
        (const ST*)vs, (const QT*)kr, (const QT*)vr, (const int*)meta,
        (const int*)win, (const float*)sinks, (const float*)alibi,
        (float*)out, G, T, C, Hkv, BQ, MC, scale, softcap);
  }
  return (int)cudaGetLastError();
}

template <int D, int DV>
int dispatch(int qd, int cd, int sd, const void* q, const void* kc,
             const void* vc, const void* ks, const void* vs, const void* kr,
             const void* vr, const void* meta, const void* win,
             const void* sinks, const void* alibi, void* out, int B, int Hkv,
             int G, int T, int C, int MC, float scale, float softcap,
             cudaStream_t st) {
#define LBT_ARGS                                                            \
  q, kc, vc, ks, vs, kr, vr, meta, win, sinks, alibi, out, B, Hkv, G, T, C, \
      MC, scale, softcap, st
  if (qd == LBT_BF16 && cd == LBT_BF16)
    return launch<bf16, bf16, float, D, DV>(LBT_ARGS);
  if (qd == LBT_F32 && cd == LBT_F32)
    return launch<float, float, float, D, DV>(LBT_ARGS);
  if (qd == LBT_BF16 && cd == LBT_I8 && sd == LBT_BF16)
    return launch<bf16, int8_t, bf16, D, DV>(LBT_ARGS);
  if (qd == LBT_BF16 && cd == LBT_I8 && sd == LBT_F32)
    return launch<bf16, int8_t, float, D, DV>(LBT_ARGS);
  if (qd == LBT_F32 && cd == LBT_I8 && sd == LBT_BF16)
    return launch<float, int8_t, bf16, D, DV>(LBT_ARGS);
  if (qd == LBT_F32 && cd == LBT_I8 && sd == LBT_F32)
    return launch<float, int8_t, float, D, DV>(LBT_ARGS);
#undef LBT_ARGS
  return LBT_UNSUPPORTED;
}

}  // namespace

// q [B,Hkv,G,T,D]; kc/vc [Bc,C,Hkv,D|DV]; ks/vs [Bc,C,Hkv] or null;
// kr/vr [B,T,Hkv,D|DV] in q's dtype; meta [B,MC] (pos0, n_valid, st, en):
// MC 4 reads cache row b (Bc = B), MC 5 the row in column 4 (< Bc);
// win [2]; sinks [Hkv,G] f32 or null; alibi [Hkv,G] f32 slopes or null;
// out [B,Hkv,G,T,DV] f32; (D, DV) one of (64, 64), (80, 80), (96, 96),
// (128, 128), (256, 256) and multi-head latent attention's (192, 128) and
// (96, 64). All contiguous, all on the device. Returns cudaGetLastError()
// after the launch, or -1 for a configuration no instantiation covers.
extern "C" int lbt_flash_prefill(int q_dtype, int kv_dtype, int scale_dtype,
                                 int D, int DV, const void* q, const void* kc,
                                 const void* vc, const void* ks,
                                 const void* vs, const void* kr,
                                 const void* vr, const void* meta,
                                 const void* win, const void* sinks,
                                 const void* alibi, void* out, int B, int Hkv,
                                 int G, int T, int C, int meta_cols,
                                 float scale, float softcap, void* stream) {
  if (G < 1 || G > kThreads || (meta_cols != 4 && meta_cols != 5))
    return LBT_UNSUPPORTED;
  cudaStream_t st = (cudaStream_t)stream;
#define LBT_WIDTHS(W, WV)                                                   \
  if (D == W && DV == WV)                                                   \
    return dispatch<W, WV>(q_dtype, kv_dtype, scale_dtype, q, kc, vc, ks,   \
                           vs, kr, vr, meta, win, sinks, alibi, out, B, Hkv, \
                           G, T, C, meta_cols, scale, softcap, st);
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
