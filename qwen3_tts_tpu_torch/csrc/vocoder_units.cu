// K6: the three dilated residual units of one SEANet decoder block, and on
// the last block the out_snake -> out_conv (k=7, Cout=1) -> clip tail.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/vocoder_kernels.py::
// _units_kernel (wrapper residual_units_fused, called by
// seanet_block_fused). Each unit: SnakeBeta -> 7-tap causal conv with
// dilation d (1, 3, 9) -> SnakeBeta -> 1x1 conv -> residual.
//
// What bounds it on the H100: the 7-tap convs are GEMMs of [S, 7C] x
// [7C, C]; over the four blocks (C = 768 -> 96, S up to T * 1920 rows) they
// are ~400 GFLOP per 110-frame row, so the kernel is bound by its FMA
// rate; the 1x1 convs and the activations add bytes, not FLOPs.
//
// Design: each unit is two launches of the shared tiled GEMM (gemm.cuh)
// with fused prologues, tiling time in 64-row tiles whose 7-tap reach
// (6 * d rows, 78 over the chain, 84 with the tail) is read straight from
// the previous unit's full-sequence output, so nothing is recomputed:
//   1. conv1: A(t, tap, c) = snake1(y[t - (6 - tap) d, c]), exact sinf,
//      0 before the sequence start (the causal zero padding, so those rows
//      stay zero by construction) -> + b1 -> h (fp32);
//   2. conv2: A = snake2(h) -> + b2 -> + y (the residual) -> y (fp32).
// The tail is one more causal 7-tap GEMM with the out_snake prologue, bias
// and clip(+-1) epilogue. The Pallas kernel instead kept a halo window in
// VMEM because the TPU grid runs in order on one core; on Hopper a
// C = 768 window with a 78-row halo does not fit a block's shared memory,
// and whole-sequence launches keep all 132 SMs busy on short sequences.

#include "gemm.cuh"

extern "C" int qt_units_gemm(const QtGemmArgs* g, void* stream) {
  return g->taps > 1 ? qt_gemm_launch<true, true>(g, stream)
                     : qt_gemm_launch<false, true>(g, stream);
}
