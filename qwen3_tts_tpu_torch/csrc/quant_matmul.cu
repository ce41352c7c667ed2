// K3: int8 group-affine matmul, y = x @ (scales * w8 + biases)^T, uint8
// weights [O, K], fp32 scales / biases per row and group of 64, dequant and
// sums in fp32, output in x's dtype.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/quant_matmul.py::
// _kernel_int8 (called through quantized_matmul_int8_pallas / int8_matmul).
//
// One C entry, one launch a call, two designs chosen by M:
// - M <= m0 (M0 in ops/cuda/quant_matmul.py; decode at M = 1, the serving
//   step at M = B, the text projection at M = 3): the GEMV of qmm_gemv.cuh
//   with BITS = 8 (the uint8 rows read as MLX's 8-bit words): one mma.sync
//   m16n8k16 takes 16 outputs' weights (exact in bf16, from registers)
//   against up to 8 rows of x, the group affine folded in fp32 after each
//   group of 64. Its plan (the K split, passed as `ks`) is
//   ops/cuda/qmm_gemv.py::plan.
// - M > m0 (the text projection at M = prompt length, prefill): the bf16
//   tensor-core tile of qmm_tile.cuh with BITS = 8 (uint8 rows are MLX's
//   8-bit words): the integer weights exact in bf16, the group affine in
//   fp32 after each group's MMAs, split-K with a fixed-order fix-up. At
//   M = 114-300 rows its bound (bytes at 114, bf16 FLOPs at 300) is 1-4
//   us; what holds it back on the H100 is each block's K step, 2-3 us in
//   which the MMAs of its 32 x 32 warp tiles take about a third and the
//   ring's barriers, the unpack, the fold and the loads the rest, plus a
//   fixed ~11 us a block wave (scripts/torch_qmm_ablation.py, PERF.md).
// K must be a multiple of 64 (the group size), x and the weight rows
// 16-byte aligned.

#include "gemm.cuh"
#include "qmm_gemv.cuh"
#include "qmm_tile.cuh"

namespace {

constexpr int Q_G = 64;

}  // namespace

extern "C" int qt_int8_matmul(const void* x, int x_bf16, const void* w8,
                              const float* scales, const float* biases, void* y,
                              int M, int O, int K, int m0, int ks, float* part,
                              int* cnt, void* stream) {
  if (M <= 0 || O <= 0) return 0;
  if (K % Q_G != 0) return (int)cudaErrorInvalidValue;
  const QtQmmArgs a{x, x_bf16, reinterpret_cast<const unsigned char*>(w8), scales, biases, Q_G,
                    y, M, O, K, ks, part, cnt};
  return M > m0 ? qt_qmm_tile<8>(a, (cudaStream_t)stream) : qt_qmm_gemv<8>(a, (cudaStream_t)stream);
}
