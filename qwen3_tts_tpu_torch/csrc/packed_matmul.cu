// K7: packed-bit group-affine matmul, y = x @ dequant(wq)^T with
//   dequant(wq)[o, k] = scales[o, k / gs] * q[o, k] + biases[o, k / gs],
// q the `bits`-bit value at bits [k * bits, (k + 1) * bits) of row o's
// little-endian uint32 bitstream (MLX's layout, as checkpoints store it);
// missing biases count as zero; sums in fp32, output in x's dtype.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/quant_matmul.py::_kernel
// (called through quantized_matmul_pallas / quantized_matmul). That kernel
// takes 2/4/8 bits on a lane-permuted copy of the weights; this one reads
// the checkpoint's rows as they are, at 2, 3, 4, 6 and 8 bits, group sizes
// 32, 64 and 128 (3- and 6-bit values cross word boundaries), any M.
//
// One C entry, one launch a call, two designs chosen by M:
// - M <= m0 (M0 in ops/cuda/packed_matmul.py; decode of the mixed
//   configuration at M = 1, the pre-quantized text projection at M = 3):
//   the GEMV of qmm_gemv.cuh, shared with K3: one mma.sync m16n8k16 takes
//   16 outputs' weights (unpacked exact into bf16 in registers: a thread's
//   8 values of a 32-value segment are `bits` bytes, one load) against up
//   to 8 rows of x, the group affine folded in fp32 after each group. Its
//   plan (the K split, passed as `ks`) is ops/cuda/qmm_gemv.py::plan.
// - M > m0 (prefill of the mixed configuration, the pre-quantized
//   configuration's text projection): the bf16 tensor-core tile of
//   qmm_tile.cuh, whose prologue unpacks the same words with the same
//   shifts into bf16 (every q exact), the group affine in fp32 after each
//   group's MMAs, split-K with a fixed-order fix-up. What bounds it at
//   M = 114-300 rows is K3's tile's (quant_matmul.cu): the K steps of each
//   block, not the bytes or the FLOPs.
// K must be a multiple of 32 and of gs, x and the weight rows 16-byte
// aligned.

#include "gemm.cuh"
#include "qmm_gemv.cuh"
#include "qmm_tile.cuh"

namespace {

constexpr int P_CHUNK = 32;

}  // namespace

extern "C" int qt_packed_matmul(const void* x, int x_bf16, const void* wq, int bits,
                                int group_size, const float* scales, const float* biases,
                                void* y, int M, int O, int K, int m0, int ks,
                                float* part, int* cnt, void* stream) {
  if (M <= 0 || O <= 0) return 0;
  if (group_size % P_CHUNK != 0 || K % group_size != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const QtQmmArgs a{x, x_bf16, reinterpret_cast<const unsigned char*>(wq), scales, biases,
                    group_size, y, M, O, K, ks, part, cnt};
  const bool tile = M > m0;
  switch (bits) {
    case 2: return tile ? qt_qmm_tile<2>(a, s) : qt_qmm_gemv<2>(a, s);
    case 3: return tile ? qt_qmm_tile<3>(a, s) : qt_qmm_gemv<3>(a, s);
    case 4: return tile ? qt_qmm_tile<4>(a, s) : qt_qmm_gemv<4>(a, s);
    case 6: return tile ? qt_qmm_tile<6>(a, s) : qt_qmm_gemv<6>(a, s);
    case 8: return tile ? qt_qmm_tile<8>(a, s) : qt_qmm_gemv<8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
