// Shared device routines for the port's Hopper kernels: typed loads and
// stores, block reductions, and one tiled GEMM with a fused prologue (plain
// rows, or causal-conv taps with an optional SnakeBeta) and a fused
// epilogue (bias, exact GELU, scaled residual, clip).
//
// The GEMM is deliberately simple: 64x64 output tiles, a K step of 16,
// 256 threads with a 4x4 fp32 micro-tile each, operands staged in shared
// memory as fp32 and multiplied with plain FMA. It is right first; wgmma,
// TMA and warp specialisation are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One GEMM call: C[m, n] = epi(sum_k A(m, k) * W[k, n]).
//
// A(m, k) with k = tap * cin + c reads row (m - shift) of `a`, channel c,
// where shift = (taps - 1 - tap) * dil and rows are grouped in sequences of
// `seq` rows: a read before the start of its sequence is 0 (causal zero
// padding). taps = 1 is a plain row-major operand. When `alpha` is set the
// loaded value goes through SnakeBeta: v + binv[c] * sin(v * alpha[c])^2.
//
// Epilogue: v = acc + bias[n]; act == 1 applies exact GELU;
// if res: v = res[m, n] + (scale ? scale[n] * v : v); clip > 0 clamps.
struct QtGemmArgs {
  const void* a;
  int a_bf16;
  long long lda;
  int seq, cin, taps, dil;
  const float* alpha;
  const float* binv;
  const void* w;  // [taps * cin, N] row-major
  int w_bf16;
  int M, N;
  void* c;
  int c_bf16;
  long long ldc;
  const float* bias;
  int act;
  const void* res;
  int res_bf16;
  long long ldr;
  const float* scale;
  float clip;
};

namespace {

__device__ __forceinline__ float qt_ld(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void qt_st(void* p, long long i, float v, int bf16) {
  if (bf16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float qt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float qt_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the whole block (blockDim.x a multiple of 32, <= 1024); every
// thread gets the total. `sh` holds at least 32 floats.
__device__ __forceinline__ float qt_block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = qt_warp_sum(v);
  __syncthreads();  // sh may still be read by a previous call
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = lane < nw ? sh[lane] : 0.f;
  return qt_warp_sum(v);
}

constexpr int QT_BM = 64, QT_BN = 64, QT_BK = 16, QT_NT = 256;

template <bool CONV, bool SNAKE>
__device__ __forceinline__ float qt_load_a(const QtGemmArgs& g, int m, int k) {
  int c = k;
  long long row = m;
  if (CONV) {
    const int tap = k / g.cin;
    c = k - tap * g.cin;
    const int shift = (g.taps - 1 - tap) * g.dil;
    if (m % g.seq < shift) return 0.f;
    row = m - shift;
  }
  float v = qt_ld(g.a, row * g.lda + c, g.a_bf16);
  if (SNAKE) {
    const float s = sinf(v * g.alpha[c]);
    v = v + g.binv[c] * (s * s);
  }
  return v;
}

template <bool CONV, bool SNAKE>
__global__ void __launch_bounds__(QT_NT) qt_gemm_kernel(const QtGemmArgs g) {
  __shared__ float As[QT_BK][QT_BM + 4];
  __shared__ float Ws[QT_BK][QT_BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * QT_BM, n0 = blockIdx.x * QT_BN;
  const int K = g.taps * g.cin;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += QT_BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, m = m0 + r, k = k0 + tx;
      As[tx][r] = (m < g.M && k < K) ? qt_load_a<CONV, SNAKE>(g, m, k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = (tid >> 6) + 4 * i, col = tid & 63;
      const int k = k0 + kk, n = n0 + col;
      Ws[kk][col] = (k < K && n < g.N) ? qt_ld(g.w, (long long)k * g.N + n, g.w_bf16) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QT_BK; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= g.N) continue;
      float v = acc[i][j];
      if (g.bias) v += g.bias[n];
      if (g.act == 1) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      if (g.res) {
        const float r = qt_ld(g.res, (long long)m * g.ldr + n, g.res_bf16);
        v = r + (g.scale ? g.scale[n] * v : v);
      }
      if (g.clip > 0.f) v = fminf(fmaxf(v, -g.clip), g.clip);
      qt_st(g.c, (long long)m * g.ldc + n, v, g.c_bf16);
    }
  }
}

template <bool CONV, bool SNAKE>
int qt_gemm_launch(const QtGemmArgs* g, void* stream) {
  if (g->M <= 0 || g->N <= 0) return 0;
  dim3 grid((g->N + QT_BN - 1) / QT_BN, (g->M + QT_BM - 1) / QT_BM);
  qt_gemm_kernel<CONV, SNAKE><<<grid, QT_NT, 0, (cudaStream_t)stream>>>(*g);
  return (int)cudaGetLastError();
}

}  // namespace
