// K5: one ConvNeXt-upsample stage of the vocoder.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/upsample_kernel.py::
// _stage_kernel (wrapper upsample_stage_fused): k=2 stride-2 transposed
// conv, causal depthwise k=7 conv, LayerNorm(1e-6), pointwise x4 with exact
// GELU, pointwise back, gamma, residual; the last stage also applies the
// SEANet initial_conv (k=7, 1024 -> 1536).
//
// What bounds it on the H100: the two pointwise GEMMs ([2T, 1024] x
// [1024, 4096] and back) and the folded 7-tap initial conv are ~4 GFLOP
// (first stage) and ~18 GFLOP (second stage, with the initial conv) for a
// 110-frame input over ~20-42 MB of bf16 weights, so a simple kernel is
// bound by its FMA rate, not by device memory.
//
// Design (launched in order by ops/cuda/upsample_kernel.py): the transposed
// conv is one GEMM whose [T, 2C] output IS the interleaved [2T, C] sequence
// in memory (column half p holds output phase p), so no interleave step
// exists; qt_dwconv_layernorm_kernel below does the causal depthwise taps
// and the LayerNorm of one row per block; the pointwise GEMMs carry bias +
// erff GELU and bias + gamma-scaled residual in their epilogues; the
// initial conv is the shared GEMM with a 7-tap causal prologue. Every GEMM
// is the hand-written tiled routine of gemm.cuh; intermediates are fp32.

#include "gemm.cuh"

namespace {

// g[m, :] = LayerNorm(b + sum_j w[j, :] * z[m - (K-1-j), :])  per sequence
// of `seq` rows (reads before the sequence start are 0). One block per row.
__global__ void qt_dwconv_layernorm_kernel(
    const float* __restrict__ z, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, float* __restrict__ g, int seq, int C, int K,
    float eps) {
  extern __shared__ float hrow[];  // [C]
  __shared__ float sh[32];
  const long long m = blockIdx.x;
  const int t = (int)(m % seq);
  float s1 = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float h = b[c];
    for (int j = 0; j < K; ++j) {
      const int shift = K - 1 - j;
      if (t >= shift) h = fmaf(w[j * C + c], z[(m - shift) * C + c], h);
    }
    hrow[c] = h;
    s1 += h;
  }
  const float mu = qt_block_sum(s1, sh) / (float)C;
  float s2 = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d = hrow[c] - mu;
    s2 += d * d;
  }
  const float r = rsqrtf(qt_block_sum(s2, sh) / (float)C + eps);
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    g[m * C + c] = (hrow[c] - mu) * r * ln_w[c] + ln_b[c];
}

}  // namespace

extern "C" int qt_up_gemm(const QtGemmArgs* g, void* stream) {
  return g->taps > 1 ? qt_gemm_launch<true, false>(g, stream)
                     : qt_gemm_launch<false, false>(g, stream);
}

extern "C" int qt_up_dwconv_layernorm(const float* z, const float* w, const float* b,
                                      const float* ln_w, const float* ln_b, float* g,
                                      int rows, int seq, int C, int K, float eps,
                                      void* stream) {
  if (rows <= 0) return 0;
  qt_dwconv_layernorm_kernel<<<rows, 256, C * sizeof(float), (cudaStream_t)stream>>>(
      z, w, b, ln_w, ln_b, g, seq, C, K, eps);
  return (int)cudaGetLastError();
}
