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
// [R, FF] in bf16 scratch that the wrapper allocates. A grid barrier
// instead would need every block resident and gains nothing here.
//
// What bounds it: bytes. wo, gate|up and down stream once (38.8 MB for a
// TinyLlama layer) for R <= 64 rows of multiply-adds per weight byte.
//
// Design: every phase is the streaming core of w8a8_common.cuh
// (stream_gemm): 128-column blocks (phase B: 64 gate columns and the 64 up
// columns that pair with them, so the activation is formed in the
// epilogue), the in-dim split so the blocks fill a wave of the card, a
// 6-stage cp.async ring of 64 x 128 weight tiles, dp4a, the splits merged
// by the block with the last ticket, each phase in its own region of the
// accumulators. Phases B and C are programmatic dependent launches
// (cudaLaunchAttributeProgrammaticStreamSerialization): phases A and B
// trigger their dependents as soon as their own weight stages are issued,
// so the next phase's blocks issue their first weight stages (which depend
// on nothing the previous phase writes) while it runs, and then wait in
// griddepcontrol.wait until it has completed and its rows are visible.
// Phase A is a normal launch, ordered after whatever ran before it. Every
// bf16 rounding of _tail_kernel is kept: attn_out, xnew, gate and up, act,
// and ffn_out before the residual; rs is rounded to bf16 as
// jnp.bfloat16(rs).
#include "w8a8_common.cuh"

namespace {

using namespace lbt_w8;

template <int EPI, bool NORM, typename NT, int RP, int VEC>
__global__ void __launch_bounds__(kThreads, 2) tail_phase_kernel(
    StreamArgs a) {
  stream_gemm<EPI, NORM, NT, RP, VEC>(a);
}

template <int EPI, bool NORM, typename NT, int RP, int VEC>
int run(const StreamArgs& a, dim3 grid, size_t smem, bool pdl,
        cudaStream_t st) {
  static unsigned done = 0;   // per device: the shared-memory limit is set
  return launch_stream(tail_phase_kernel<EPI, NORM, NT, RP, VEC>, done, grid,
                       smem, pdl, a, st);
}

template <int EPI, bool NORM, typename NT, int RP>
int by_vec(int vec, const StreamArgs& a, dim3 grid, size_t smem, bool pdl,
           cudaStream_t st) {
  if (vec == 16) return run<EPI, NORM, NT, RP, 16>(a, grid, smem, pdl, st);
  if (vec == 8) return run<EPI, NORM, NT, RP, 8>(a, grid, smem, pdl, st);
  return run<EPI, NORM, NT, RP, 4>(a, grid, smem, pdl, st);
}

// one phase: geometry, copy width and rows per block, then the launch
template <int EPI, bool NORM, typename NT>
int phase(StreamArgs a, int splits, int up, bool pdl, cudaStream_t st) {
  a.pdl = pdl;
  int rp;
  dim3 grid;
  size_t smem;
  if (!geometry(a, EPI == kGateUp ? kHalf : kTileN, splits,
                NORM ? sizeof(NT) : 0, rp, grid, smem))
    return LBT_UNSUPPORTED;
  const int vec = copy_bytes(a.w, a.ldw, up);
  if (rp == 1) return by_vec<EPI, NORM, NT, 1>(vec, a, grid, smem, pdl, st);
  if (rp == 2) return by_vec<EPI, NORM, NT, 2>(vec, a, grid, smem, pdl, st);
  if (rp == 4) return by_vec<EPI, NORM, NT, 4>(vec, a, grid, smem, pdl, st);
  return by_vec<EPI, NORM, NT, 8>(vec, a, grid, smem, pdl, st);
}

struct Tail {
  const void *ao, *xres, *wo, *wo_sc, *nw, *gu, *gu_sc, *dn, *dn_sc;
  void *xnew, *act, *out, *amax;
  void* acc[3];
  void* cnt[3];
  int splits[3];
  int R, HD, E, FF, act_fn;
  float eps, rs;
};

template <typename NT>
int launch_tail(const Tail& t, cudaStream_t st) {
  // phase p: rows x . w [K, ldw] -> out [R, N]; the norm weight in B only
  auto args = [&](int p, const void* x, const void* w, const void* ws,
                  const void* res, void* out, int K, int N, int ldw) {
    return StreamArgs{(const bf16*)x, p == 1 ? t.nw : nullptr,
                      (const int8_t*)w, (const float*)ws, (const bf16*)res,
                      (bf16*)out, (int*)t.acc[p], (unsigned*)t.cnt[p], t.R,
                      K, N, ldw, 0, t.eps, t.rs, t.act_fn,
                      (unsigned*)t.amax, kAmaxClear + p, 0, 0};
  };
  int rc = phase<kResid, false, float>(
      args(0, t.ao, t.wo, t.wo_sc, t.xres, t.xnew, t.HD, t.E, t.E),
      t.splits[0], 0, false, st);
  if (rc) return rc;
  rc = phase<kGateUp, true, NT>(
      args(1, t.xnew, t.gu, t.gu_sc, nullptr, t.act, t.E, t.FF, 2 * t.FF),
      t.splits[1], t.FF, true, st);
  if (rc) return rc;
  return phase<kResid, false, float>(
      args(2, t.act, t.dn, t.dn_sc, t.xnew, t.out, t.FF, t.E, t.E),
      t.splits[2], 0, true, st);
}

}  // namespace

// ao [R, HD] bf16; xres [R, E] bf16; wo [HD, E], gu [E, 2*FF] (gate columns
// first), dn [FF, E] int8 (4-byte aligned) with f32 column scales; nw [E]
// bf16 or f32 (16-byte aligned), nw_dtype as LbtDtype; xnew [R, E] and act
// [R, FF] bf16 scratch; out [R, E] bf16; rows 8-byte aligned. amax: at
// least R unsigned ints (the rows' max |act|, from phase B to phase C).
// acc_{a,b,c} / cnt_{a,b,c}: each phase's split sums and tickets,
// as lbt_fused_norm_qmm's (phase B's tiles are 64 gate columns: ceil(FF /
// 64) of them), needed where that phase's splits_{a,b,c} > 1, 0 before the
// call and 0 after it. act_fn: 0 silu, 1 gelu (tanh), 2 relu2. All
// contiguous on the device, every width a multiple of 4. Returns the first
// non-zero error of the three launches, or -1 for a configuration the
// kernels do not take.
extern "C" int lbt_fused_layer_tail(
    int nw_dtype, const void* ao, const void* xres, const void* wo,
    const void* wo_sc, const void* nw, const void* gu, const void* gu_sc,
    const void* dn, const void* dn_sc, void* xnew, void* act, void* out,
    void* amax, void* acc_a, void* cnt_a, void* acc_b, void* cnt_b,
    void* acc_c, void* cnt_c, int splits_a, int splits_b, int splits_c,
    int R, int HD, int E, int FF, float eps, float rs, int act_fn,
    void* stream) {
  if (R < 1 || HD % 4 || E % 4 || FF % 4 || HD < 4 || E < 4 || FF < 4 ||
      act_fn < kSilu || act_fn > kRelu2 || !amax)
    return LBT_UNSUPPORTED;
  const Tail t{ao,    xres, wo,    wo_sc, nw,  gu,  gu_sc,
               dn,    dn_sc, xnew, act,   out, amax,
               {acc_a, acc_b, acc_c}, {cnt_a, cnt_b, cnt_c},
               {splits_a, splits_b, splits_c}, R, HD, E, FF, act_fn, eps, rs};
  cudaStream_t st = (cudaStream_t)stream;
  if (nw_dtype == LBT_BF16) return launch_tail<bf16>(t, st);
  if (nw_dtype == LBT_F32) return launch_tail<float>(t, st);
  return LBT_UNSUPPORTED;
}
