// Fused rms_norm -> per-row int8 -> s8 x s8 -> s32 -> rescale -> bf16.
//
// Replaces the Pallas kernel _norm_qmm_kernel / fused_norm_qmm
// (llama_box_tpu/ops/fused_decode.py:67, :76): the fused q/k/v projection
// and the output (vocab) projection at decode widths, R <= 64 rows.
//
// What bounds it: bytes. The weights [E, O] int8 stream once (5.2 MB for
// TinyLlama's wqkv, 65.5 MB for its 32000-wide output) and each weight
// byte feeds R multiply-adds, far below the card's int8 ridge. The TPU
// kernel tiled the output columns and kept the R rows resident in VMEM.
//
// Design: one launch of the streaming core of w8a8_common.cuh
// (stream_gemm): 128-column blocks, the in-dim split so the blocks fill a
// wave of the card, 64 x 128 weight tiles through a 6-stage cp.async ring,
// dp4a on in-register transposed weight words, the splits' int32 sums
// merged by the block with the last ticket. Each block norms and
// quantizes its rows itself (at R = 4, E = 2048: 16 KB of reads from L2,
// cheaper than a second launch). The epilogue is float(acc) * xs * scale,
// rounded to bf16.
#include "w8a8_common.cuh"

namespace {

using namespace lbt_w8;

template <typename NT, int RP, int VEC>
__global__ void __launch_bounds__(kThreads, 2) norm_qmm_kernel(StreamArgs a) {
  stream_gemm<kRescale, true, NT, RP, VEC>(a);
}

template <typename NT, int RP, int VEC>
int run(const StreamArgs& a, dim3 grid, size_t smem, cudaStream_t st) {
  static unsigned done = 0;   // per device: the shared-memory limit is set
  return launch_stream(norm_qmm_kernel<NT, RP, VEC>, done, grid, smem, false,
                       a, st);
}

template <typename NT, int RP>
int by_vec(int vec, const StreamArgs& a, dim3 grid, size_t smem,
           cudaStream_t st) {
  if (vec == 16) return run<NT, RP, 16>(a, grid, smem, st);
  if (vec == 8) return run<NT, RP, 8>(a, grid, smem, st);
  return run<NT, RP, 4>(a, grid, smem, st);
}

template <typename NT>
int by_rows(int rp, int vec, const StreamArgs& a, dim3 grid, size_t smem,
            cudaStream_t st) {
  if (rp == 1) return by_vec<NT, 1>(vec, a, grid, smem, st);
  if (rp == 2) return by_vec<NT, 2>(vec, a, grid, smem, st);
  if (rp == 4) return by_vec<NT, 4>(vec, a, grid, smem, st);
  return by_vec<NT, 8>(vec, a, grid, smem, st);
}

}  // namespace

// x [R, E] bf16; nw [E] bf16 or f32, nw_dtype as LbtDtype (both 16-byte
// aligned); w [E, O] int8, 4-byte aligned;
// ws [O] f32; out [R, O] bf16. With splits > 1 (the in-dim split, 1 <=
// splits <= ceil(E / 64)): acc, int32, at least ceil(R / 8) * 8 *
// ceil(O / 128) * 128 of them, and cnt, R * ceil(O / 128) unsigned ints,
// all 0 before the call and 0 again after it (calls sharing them run on one
// stream). All contiguous on the device, E and O multiples of 4. Returns
// cudaGetLastError() after the launch, or -1 for a configuration the
// kernel does not take.
extern "C" int lbt_fused_norm_qmm(int nw_dtype, const void* x,
                                  const void* nw, const void* w,
                                  const void* ws, void* out, void* acc,
                                  void* cnt, int R, int E, int O, int splits,
                                  float eps, void* stream) {
  if (R < 1 || E < 4 || O < 4 || E % 4 || O % 4) return LBT_UNSUPPORTED;
  if (nw_dtype != LBT_BF16 && nw_dtype != LBT_F32) return LBT_UNSUPPORTED;
  StreamArgs a{(const bf16*)x, nw, (const int8_t*)w, (const float*)ws,
               nullptr, (bf16*)out, (int*)acc, (unsigned*)cnt, R, E, O, O,
               0, eps, 1.f, 0, nullptr, kAmaxNone, 0, 0};
  int rp;
  dim3 grid;
  size_t smem;
  if (!geometry(a, kTileN, splits, nw_dtype == LBT_BF16 ? 2 : 4, rp, grid,
                smem))
    return LBT_UNSUPPORTED;
  const int vec = copy_bytes(w, O, 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (nw_dtype == LBT_BF16) return by_rows<bf16>(rp, vec, a, grid, smem, st);
  return by_rows<float>(rp, vec, a, grid, smem, st);
}
