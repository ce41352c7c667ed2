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
// - M <= m0 (M0 = 8 in ops/cuda/packed_matmul.py; decode): a GEMV, bound by
//   device memory bandwidth (3.35 TB/s; the bytes are bits / 16 of bf16's,
//   plus 8 bytes of scale and bias a group). One warp per output feature,
//   eight features per block, up to eight activation rows per block
//   (grid.y walks M in steps of 8). A lane takes 32 consecutive values of
//   the row at a time: exactly `bits` words, word-aligned and inside one
//   group, read with the widest aligned vector load (16 bytes for 4 and 8
//   bits, 8 for 2 and 6, 4 for 3), unpacked with compile-time shifts,
//   dequantized in fp32 as q * s + b (as the Pallas kernel does) and
//   multiplied with the activation rows; a warp reduction gives each output.
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
#include "qmm_tile.cuh"

namespace {

constexpr int P_WARPS = 8, P_MT = 8, P_CHUNK = 32;

// dot of 32 consecutive activations x[off .. off + 31] with w[0 .. 31]
__device__ __forceinline__ float dot32(const void* __restrict__ x, long long off, int bf16,
                                       const float* w) {
  float a = 0.f;
  if (bf16) {
    const uint4* p = reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(x) + off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = p[i];
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a bf16 is the high half of an fp32
        a = fmaf(__uint_as_float(u[j] << 16), w[8 * i + 2 * j], a);
        a = fmaf(__uint_as_float(u[j] & 0xffff0000u), w[8 * i + 2 * j + 1], a);
      }
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(x) + off);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 v = p[i];
      a = fmaf(v.x, w[4 * i], a);
      a = fmaf(v.y, w[4 * i + 1], a);
      a = fmaf(v.z, w[4 * i + 2], a);
      a = fmaf(v.w, w[4 * i + 3], a);
    }
  }
  return a;
}

template <int BITS>
__global__ void __launch_bounds__(P_WARPS * 32) qt_packed_matmul_kernel(
    const void* __restrict__ x, int x_bf16, const uint32_t* __restrict__ wq,
    const float* __restrict__ scales, const float* __restrict__ biases, int gs,
    void* __restrict__ y, int M, int O, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = blockIdx.x * P_WARPS + warp;
  const int m0 = blockIdx.y * P_MT;
  if (o >= O) return;
  const int mt = min(P_MT, M - m0);
  const int chunks = K / P_CHUNK, G = K / gs;
  const uint32_t* wrow = wq + (long long)o * chunks * BITS;
  float acc[P_MT];
#pragma unroll
  for (int r = 0; r < P_MT; ++r) acc[r] = 0.f;

  for (int c = lane; c < chunks; c += 32) {
    uint32_t words[BITS];
    load_chunk<BITS>(wrow + c * BITS, words);
    const long long gi = (long long)o * G + c * P_CHUNK / gs;
    const float s = scales[gi], b = biases ? biases[gi] : 0.f;
    float w[P_CHUNK];
#pragma unroll
    for (int v = 0; v < P_CHUNK; ++v) w[v] = (float)qt_unpack_q<BITS>(words, v) * s + b;
#pragma unroll
    for (int r = 0; r < P_MT; ++r)
      if (r < mt) acc[r] += dot32(x, (long long)(m0 + r) * K + c * P_CHUNK, x_bf16, w);
  }
#pragma unroll
  for (int r = 0; r < P_MT; ++r) {
    const float t = qt_warp_sum(acc[r]);
    if (lane == 0 && r < mt) qt_st(y, (long long)(m0 + r) * O + o, t, x_bf16);
  }
}

template <int BITS>
int launch(const void* x, int x_bf16, const void* wq, const float* scales,
           const float* biases, int gs, void* y, int M, int O, int K, cudaStream_t stream) {
  dim3 grid((O + P_WARPS - 1) / P_WARPS, (M + P_MT - 1) / P_MT);
  qt_packed_matmul_kernel<BITS><<<grid, P_WARPS * 32, 0, stream>>>(
      x, x_bf16, reinterpret_cast<const uint32_t*>(wq), scales, biases, gs, y, M, O, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qt_packed_matmul(const void* x, int x_bf16, const void* wq, int bits,
                                int group_size, const float* scales, const float* biases,
                                void* y, int M, int O, int K, int m0, int ks,
                                float* part, int* cnt, void* stream) {
  if (M <= 0 || O <= 0) return 0;
  if (group_size % P_CHUNK != 0 || K % group_size != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (M > m0) {
    const QtQmmArgs a{x, x_bf16, reinterpret_cast<const unsigned char*>(wq), scales, biases,
                      group_size, y, M, O, K, ks, part, cnt};
    switch (bits) {
      case 2: return qt_qmm_tile<2>(a, s);
      case 3: return qt_qmm_tile<3>(a, s);
      case 4: return qt_qmm_tile<4>(a, s);
      case 6: return qt_qmm_tile<6>(a, s);
      case 8: return qt_qmm_tile<8>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (bits) {
    case 2: return launch<2>(x, x_bf16, wq, scales, biases, group_size, y, M, O, K, s);
    case 3: return launch<3>(x, x_bf16, wq, scales, biases, group_size, y, M, O, K, s);
    case 4: return launch<4>(x, x_bf16, wq, scales, biases, group_size, y, M, O, K, s);
    case 6: return launch<6>(x, x_bf16, wq, scales, biases, group_size, y, M, O, K, s);
    case 8: return launch<8>(x, x_bf16, wq, scales, biases, group_size, y, M, O, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
