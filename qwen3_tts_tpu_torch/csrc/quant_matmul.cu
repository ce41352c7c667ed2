// K3: int8 group-affine matmul, y = x @ (scales * w8 + biases)^T, uint8
// weights [O, K], fp32 scales / biases per row and group of 64, dequant and
// sums in fp32, output in x's dtype.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/quant_matmul.py::
// _kernel_int8 (called through quantized_matmul_int8_pallas / int8_matmul).
//
// One C entry, one launch a call, two designs chosen by M:
// - M <= m0 (M0 = 3 in ops/cuda/quant_matmul.py; decode): a GEMV, bound by
//   device memory bandwidth (3.35 TB/s; each weight byte read once for ~2
//   FLOPs, int8 storage halves the bytes of bf16). One warp per output
//   feature, eight features per block, up to eight activation rows per
//   block (grid.y walks M in steps of 8). Each lane reads 16 consecutive
//   uint8 weights at a time (one 16-byte load, coalesced across the warp
//   along K), dequantizes them as s * q + b in fp32 (as the Pallas kernel
//   does), multiplies them with the activation rows and accumulates in
//   fp32; a warp reduction gives each output.
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
#include "qmm_tile.cuh"

namespace {

constexpr int Q_G = 64, Q_WARPS = 8, Q_MT = 8;

__global__ void __launch_bounds__(Q_WARPS * 32) qt_int8_matmul_kernel(
    const void* __restrict__ x, int x_bf16, const uint8_t* __restrict__ w8,
    const float* __restrict__ scales, const float* __restrict__ biases,
    void* __restrict__ y, int M, int O, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = blockIdx.x * Q_WARPS + warp;
  const int m0 = blockIdx.y * Q_MT;
  if (o >= O) return;
  const int mt = min(Q_MT, M - m0);
  const int G = K / Q_G;
  const uint8_t* wrow = w8 + (long long)o * K;
  float acc[Q_MT];
#pragma unroll
  for (int r = 0; r < Q_MT; ++r) acc[r] = 0.f;

  for (int k = lane * 16; k < K; k += 32 * 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(wrow + k);
    const int g = k / Q_G;
    const float s = scales[(long long)o * G + g], b = biases[(long long)o * G + g];
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    float w[16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) w[4 * i + j] = (float)((words[i] >> (8 * j)) & 0xffu) * s + b;
#pragma unroll
    for (int r = 0; r < Q_MT; ++r) {
      if (r < mt) {
        const long long xo = (long long)(m0 + r) * K + k;
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) a = fmaf(qt_ld(x, xo + j, x_bf16), w[j], a);
        acc[r] += a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < Q_MT; ++r) {
    const float t = qt_warp_sum(acc[r]);
    if (lane == 0 && r < mt) qt_st(y, (long long)(m0 + r) * O + o, t, x_bf16);
  }
}

}  // namespace

extern "C" int qt_int8_matmul(const void* x, int x_bf16, const void* w8,
                              const float* scales, const float* biases, void* y,
                              int M, int O, int K, int m0, int ks, float* part,
                              int* cnt, void* stream) {
  if (M <= 0 || O <= 0) return 0;
  if (K % Q_G != 0) return (int)cudaErrorInvalidValue;
  if (M > m0) {
    const QtQmmArgs a{x, x_bf16, reinterpret_cast<const unsigned char*>(w8), scales, biases, Q_G,
                      y, M, O, K, ks, part, cnt};
    return qt_qmm_tile<8>(a, (cudaStream_t)stream);
  }
  dim3 grid((O + Q_WARPS - 1) / Q_WARPS, (M + Q_MT - 1) / Q_MT);
  qt_int8_matmul_kernel<<<grid, Q_WARPS * 32, 0, (cudaStream_t)stream>>>(
      x, x_bf16, reinterpret_cast<const uint8_t*>(w8), scales, biases, y, M, O, K);
  return (int)cudaGetLastError();
}
