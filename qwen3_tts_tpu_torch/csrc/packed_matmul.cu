// K7: packed-bit group-affine matmul, y = x @ dequant(wq)^T with
//   dequant(wq)[o, k] = scales[o, k / gs] * q[o, k] + biases[o, k / gs],
// q the `bits`-bit value at bits [k * bits, (k + 1) * bits) of row o's
// little-endian uint32 bitstream (MLX's layout, as checkpoints store it).
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/quant_matmul.py::_kernel
// (called through quantized_matmul_pallas / quantized_matmul). That kernel
// takes 2/4/8 bits on a lane-permuted copy of the weights; this one reads
// the checkpoint's rows as they are, at 2, 3, 4, 6 and 8 bits, group sizes
// 32, 64 and 128 (3- and 6-bit values cross word boundaries).
//
// What bounds it on the H100: at decode (M = 1) it is a GEMV that reads each
// packed weight once for 2 FLOPs per value, so it is bound by device memory
// bandwidth (3.35 TB/s): the bytes are bits / 16 of bf16's, plus the fp32
// scales and biases (8 bytes per group). At prefill (M = a few hundred rows)
// each 8-row slice re-reads the weights from L2 and the FMA rate bounds it.
//
// Design (simple first; as K3 in quant_matmul.cu): one warp per output
// feature, eight features per block, up to eight activation rows per block
// (grid.y walks M in steps of 8). A lane takes 32 consecutive values of the
// row at a time: exactly `bits` words, word-aligned and inside one group (gs
// is a multiple of 32), read with the widest aligned vector load (16 bytes
// for 4 and 8 bits, 8 bytes for 2 and 6, 4 bytes for 3). The unpack is
// unrolled with compile-time shifts per width; a value that crosses a word
// boundary ORs in the high bits from the next word of the pair. Values are
// dequantized in fp32 as q * s + b (as the Pallas kernel does), multiplied
// with the activation rows (vector loads through L1) and summed in fp32; a
// warp reduction gives each output, written in x's dtype. K must be a
// multiple of 32 and of gs, and the weight rows 16-byte aligned.

#include "gemm.cuh"

namespace {

constexpr int P_WARPS = 8, P_MT = 8, P_CHUNK = 32;

// the `BITS` words of one 32-value chunk, read as wide as their alignment
// allows (a chunk starts at a multiple of 4 * BITS bytes from the row start)
template <int BITS>
__device__ __forceinline__ void load_chunk(const uint32_t* __restrict__ p, uint32_t* w) {
  if constexpr (BITS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < BITS / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
    }
  } else if constexpr (BITS % 2 == 0) {
#pragma unroll
    for (int i = 0; i < BITS / 2; ++i) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = v.x, w[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BITS; ++i) w[i] = p[i];
  }
}

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
  constexpr uint32_t MASK = (1u << BITS) - 1u;
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
    for (int v = 0; v < P_CHUNK; ++v) {
      const int bit = v * BITS, wi = bit >> 5, off = bit & 31;
      uint32_t q = words[wi] >> off;
      if (off + BITS > 32) q |= words[min(wi + 1, BITS - 1)] << (32 - off);
      w[v] = (float)(q & MASK) * s + b;
    }
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
                                void* y, int M, int O, int K, void* stream) {
  if (M <= 0 || O <= 0) return 0;
  if (group_size % P_CHUNK != 0 || K % group_size != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 2: return launch<2>(x, x_bf16, wq, scales, biases, group_size, y, M, O, K, s);
    case 3: return launch<3>(x, x_bf16, wq, scales, biases, group_size, y, M, O, K, s);
    case 4: return launch<4>(x, x_bf16, wq, scales, biases, group_size, y, M, O, K, s);
    case 6: return launch<6>(x, x_bf16, wq, scales, biases, group_size, y, M, O, K, s);
    case 8: return launch<8>(x, x_bf16, wq, scales, biases, group_size, y, M, O, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
