// Shared phases of the megakernels K1 (talker_step.cu) and K2 (cp_frame.cu):
// the W8A8 GEMV and the single-token attention over a small KV cache.
//
// W8A8 arithmetic, exactly as the reference defines it
// (qwen3_tts_tpu/ops/pallas/cp_megakernel.py::_w8a8):
//   sx = max(max|x| / 127, 1e-12)
//   xq = clip(round_half_even(x / sx), -127, 127)        (true division)
//   y[o] = sx * s[o] * acc[o] + m[o] * (sx * sum(xq)),   acc = xq . q[o] in int32
// The integer dot uses __dp4a and is exact; the epilogue is written with
// __fmul_rn / __fadd_rn so that no multiply-add is contracted and it rounds
// as the plain PyTorch version does.
//
// A GEMV phase is one launch over all SMs: one warp per output row, eight
// rows per block, ceil(O / 8) blocks. Every block rebuilds the int8 input
// row itself from the fp32 source (<= 12 KB, read from L2): RMSNorm or
// SiLU(gate) * up, the row's max |x|, the quantization and sum(xq). That
// costs a few microseconds of redundant arithmetic and saves a grid-wide
// barrier per phase. Each lane then streams 16 weight bytes at a time
// (coalesced along K) against the matching 16 bytes of xq in shared memory.

#pragma once

#include "gemm.cuh"

#define QT_TRY(expr)            \
  do {                          \
    const int rc_ = (expr);     \
    if (rc_ != 0) return rc_;   \
  } while (0)

// A stack of W8A8 decoder layers and the fp32 scratch rows one token's pass
// through it uses: the first member of QtTalkerArgs and of QtCpArgs.
struct QtLayers {
  const int8_t *qkv_q, *o_q, *gu_q, *dn_q;                             // [nl, O, K]
  const float *qkv_s, *qkv_m, *o_s, *o_m, *gu_s, *gu_m, *dn_s, *dn_m;  // [nl, 1, O]
  const float *in_ln, *post_ln, *q_ln, *k_ln;                          // [nl, 1, d]
  float *h, *qkv, *attn, *gu;  // [hc], [(nq + 2 nkv) hd], [nq hd], [2 inter]
  int nl, hc, nq, nkv, hd, inter;
  float eps;
};

namespace {

constexpr int W8_WARPS = 8, W8_NT = W8_WARPS * 32, W8_KMAX = 8192;
constexpr int ATT_NT = 512, ATT_UNROLL = 4;

// How a GEMV block builds its input row x[0:K] from `src`.
enum QtVecMode { QT_VEC_PLAIN = 0, QT_VEC_RMS = 1, QT_VEC_SILU = 2 };

struct QtGemv {
  const float* src;  // fp32 input; QT_VEC_SILU reads [2K]: gate then up
  int mode;
  const float* ln;   // RMSNorm gain [K] (QT_VEC_RMS)
  float eps;
  int K, O;
  const int8_t* q;   // [O, K]
  const float* s;    // [O]
  const float* m;    // [O]
  float* dst;        // [O] fp32
  int residual;      // dst[o] = dst[o] + y instead of dst[o] = y
};

__device__ __forceinline__ float qt_silu(float g) { return g / (1.f + expf(-g)); }

__device__ __forceinline__ float qt_block_max(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = qt_warp_max(v);
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = lane < nw ? sh[lane] : -INFINITY;
  return qt_warp_max(v);
}

// x[i] of the GEMV input row (rinv = 1/sqrt(mean(src^2) + eps) for RMS)
__device__ __forceinline__ float qt_vec_x(const QtGemv& g, int i, float rinv) {
  if (g.mode == QT_VEC_RMS) return __fmul_rn(__fmul_rn(g.src[i], rinv), g.ln[i]);
  if (g.mode == QT_VEC_SILU) return __fmul_rn(qt_silu(g.src[i]), g.src[g.K + i]);
  return g.src[i];
}

// 1 / sqrt(mean(v^2) + eps) over v[0:n], for every thread of the block
__device__ __forceinline__ float qt_block_rinv(const float* v, int n, float eps, float* sh) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) ss = fmaf(v[i], v[i], ss);
  const float ms = qt_block_sum(ss, sh) / (float)n;
  return 1.f / sqrtf(ms + eps);
}

__global__ void __launch_bounds__(W8_NT) qt_w8a8_gemv_kernel(const QtGemv g) {
  __shared__ __align__(16) int8_t xq[W8_KMAX];
  __shared__ float sh[32];
  const int K = g.K;
  const float rinv = g.mode == QT_VEC_RMS ? qt_block_rinv(g.src, K, g.eps, sh) : 1.f;
  float ax = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) ax = fmaxf(ax, fabsf(qt_vec_x(g, i, rinv)));
  ax = qt_block_max(ax, sh);
  const float sx = fmaxf(ax / 127.f, 1e-12f);
  float part = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float x = qt_vec_x(g, i, rinv);
    const float r = fminf(fmaxf(rintf(x / sx), -127.f), 127.f);
    xq[i] = (int8_t)r;
    part += r;
  }
  const float sum_xq = qt_block_sum(part, sh);  // exact: integers below 2^24
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = blockIdx.x * W8_WARPS + warp; o < g.O; o += gridDim.x * W8_WARPS) {
    const int8_t* row = g.q + (long long)o * K;
    int acc = 0;
#pragma unroll 4
    for (int k = lane * 16; k < K; k += 32 * 16) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(row + k));
      const int4 a = *reinterpret_cast<const int4*>(xq + k);
      acc = __dp4a(w.x, a.x, acc);
      acc = __dp4a(w.y, a.y, acc);
      acc = __dp4a(w.z, a.z, acc);
      acc = __dp4a(w.w, a.w, acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const float y = __fadd_rn(__fmul_rn(__fmul_rn(sx, g.s[o]), (float)acc),
                                __fmul_rn(g.m[o], __fmul_rn(sx, sum_xq)));
      g.dst[o] = g.residual ? __fadd_rn(g.dst[o], y) : y;
    }
  }
}

int qt_gemv(const QtGemv& g, cudaStream_t st) {
  if (g.K % 16 != 0 || g.K > W8_KMAX || g.O <= 0) return (int)cudaErrorInvalidValue;
  qt_w8a8_gemv_kernel<<<(g.O + W8_WARPS - 1) / W8_WARPS, W8_NT, 0, st>>>(g);
  return (int)cudaGetLastError();
}

// One token's attention for one layer; one block (512 threads) per query
// head.
//
// Talker (cp_t < 0): a ring cache [C, nkv * hd] (bf16 or fp32) whose slots
// hold absolute positions pos[C]; a slot counts when pos >= 0 and pos >=
// window_start, and the current token enters as a separate fp32 column (not
// the rounded row written into the ring): out = (sum_c e_c v_c + e_cur v) /
// (sum_c e_c + e_cur). The new K/V rows go into slot position % C, which
// stays masked (its pos is the old one) until the caller writes pos after
// the last layer.
// Code predictor (cp_t >= 0): an fp32 cache of 16 slots; the token is
// written to slot cp_t and slots 0..cp_t count; p = softmax, out = p . v.
// The token's own K/V come from shared memory, not from the cache another
// block may still be writing.
struct QtAttn {
  const float* qkv;   // [(nq + 2 nkv) hd] fp32: q | k | v of this token
  const float* q_ln;  // [hd]
  const float* k_ln;  // [hd]
  const float* cos;   // [hd] for this position
  const float* sin;
  void* kc;           // this layer's cache [C, nkv * hd]
  void* vc;
  int kv_bf16;
  const long long* pos;       // talker: [C]
  const long long* position;  // talker: device scalar
  const long long* ws;        // talker: device scalar (window start)
  int cp_t;
  int C, nq, nkv, hd;
  float eps, scale;
  float* out;  // [nq * hd]
};

__global__ void __launch_bounds__(ATT_NT) qt_attention_kernel(const QtAttn a) {
  extern __shared__ float sc[];  // [C] scores, then weights
  __shared__ float qs[256], ks[256], vs[256], red[ATT_NT];  // hd <= 256
  __shared__ float sh[32];
  const int i = blockIdx.x, hd = a.hd, group = a.nq / a.nkv, j = i / group;
  const int tid = threadIdx.x, kvw = a.nkv * hd;
  const bool cp = a.cp_t >= 0;
  const float* qr = a.qkv + (long long)i * hd;
  const float* kr = a.qkv + (long long)a.nq * hd + j * hd;
  const float* vr = a.qkv + (long long)(a.nq + a.nkv) * hd + j * hd;

  // per-head RMSNorm, then RoPE (rotate-half)
  const float rq = qt_block_rinv(qr, hd, a.eps, sh);
  const float rk = qt_block_rinv(kr, hd, a.eps, sh);
  float qn = 0.f, kn = 0.f;
  if (tid < hd) {
    qn = __fmul_rn(__fmul_rn(qr[tid], rq), a.q_ln[tid]);
    kn = __fmul_rn(__fmul_rn(kr[tid], rk), a.k_ln[tid]);
    qs[tid] = qn;
    ks[tid] = kn;
    vs[tid] = vr[tid];
  }
  __syncthreads();
  float qv = 0.f, kv = 0.f;
  if (tid < hd) {
    const int h2 = hd / 2;
    const float rq_ = tid < h2 ? -qs[tid + h2] : qs[tid - h2];
    const float rk_ = tid < h2 ? -ks[tid + h2] : ks[tid - h2];
    qv = __fadd_rn(__fmul_rn(qn, a.cos[tid]), __fmul_rn(rq_, a.sin[tid]));
    kv = __fadd_rn(__fmul_rn(kn, a.cos[tid]), __fmul_rn(rk_, a.sin[tid]));
  }
  __syncthreads();
  if (tid < hd) {
    qs[tid] = qv;
    ks[tid] = kv;
  }
  long long slot;
  int n;
  if (cp) {
    slot = a.cp_t;
    n = a.cp_t + 1;
  } else {
    slot = *a.position % a.C;
    n = a.C;
  }
  if (tid < hd && i % group == 0) {
    qt_st(a.kc, slot * kvw + j * hd + tid, kv, a.kv_bf16);
    qt_st(a.vc, slot * kvw + j * hd + tid, vs[tid], a.kv_bf16);
  }
  __syncthreads();

  // scores: each warp takes ATT_UNROLL slots at a time (their loads in
  // flight together), lanes along hd
  const int lane = tid & 31, warp = tid >> 5, nw = ATT_NT / 32;
  const long long ws = cp ? 0 : *a.ws;
  for (int c0 = warp * ATT_UNROLL; c0 < n; c0 += nw * ATT_UNROLL) {
    float d[ATT_UNROLL];
#pragma unroll
    for (int u = 0; u < ATT_UNROLL; ++u) {
      const int c = c0 + u;
      d[u] = 0.f;
      if (c >= n) continue;
      if (cp && c == a.cp_t) {
        for (int e = lane; e < hd; e += 32) d[u] = fmaf(qs[e], ks[e], d[u]);
      } else {
        for (int e = lane; e < hd; e += 32)
          d[u] = fmaf(qs[e], qt_ld(a.kc, (long long)c * kvw + j * hd + e, a.kv_bf16), d[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < ATT_UNROLL; ++u) {
      const int c = c0 + u;
      const float s = qt_warp_sum(d[u]) * a.scale;
      if (lane == 0 && c < n) {
        const bool valid = cp || (a.pos[c] >= 0 && a.pos[c] >= ws);
        sc[c] = valid ? s : -1e30f;
      }
    }
  }
  float cur = 0.f;
  if (!cp) cur = qt_block_sum(tid < hd ? qs[tid] * ks[tid] : 0.f, sh) * a.scale;
  __syncthreads();
  float mx = -INFINITY;
  for (int c = tid; c < n; c += ATT_NT) mx = fmaxf(mx, sc[c]);
  mx = qt_block_max(mx, sh);
  if (!cp) mx = fmaxf(mx, cur);
  float part = 0.f;
  for (int c = tid; c < n; c += ATT_NT) {
    const float e = expf(sc[c] - mx);
    sc[c] = e;
    part += e;
  }
  const float e_cur = cp ? 0.f : expf(cur - mx);
  const float denom = qt_block_sum(part, sh) + e_cur;  // syncs: sc complete
  if (cp) {
    for (int c = tid; c < n; c += ATT_NT) sc[c] = sc[c] / denom;
    __syncthreads();
  }

  // out[d]: ATT_NT / hd slices of the slots per d, then a sum of slices
  const int d = tid % hd, slice = tid / hd, ns = ATT_NT / hd;
  float acc = 0.f;
  if (slice < ns) {
#pragma unroll 8
    for (int c = slice; c < n; c += ns) {
      const float v = (cp && c == a.cp_t) ? vs[d]
                                          : qt_ld(a.vc, (long long)c * kvw + j * hd + d, a.kv_bf16);
      acc = fmaf(sc[c], v, acc);
    }
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < hd) {
    float s = 0.f;
    for (int k = 0; k < ns; ++k) s += red[k * hd + tid];
    a.out[(long long)i * hd + tid] = cp ? s : (s + e_cur * vs[tid]) / denom;
  }
}

int qt_attention(const QtAttn& a, cudaStream_t st) {
  if (a.hd > 256 || ATT_NT % a.hd != 0 || a.nq % a.nkv != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(a.cp_t >= 0 ? a.cp_t + 1 : a.C) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qt_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  qt_attention_kernel<<<a.nq, ATT_NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// dst[i] = float(src[i]) for i < n (fp32 or bf16 source)
__global__ void qt_load_row_kernel(const void* src, int src_bf16, float* dst, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    dst[i] = qt_ld(src, i, src_bf16);
}

int qt_load_row(const void* src, int src_bf16, float* dst, int n, cudaStream_t st) {
  qt_load_row_kernel<<<(n + 255) / 256, 256, 0, st>>>(src, src_bf16, dst, n);
  return (int)cudaGetLastError();
}

// Decoder layer l for the token whose hidden state is in w.h: the qkv GEMV
// (RMSNorm prologue), the attention `at` (the caller fills in its cache:
// kc, vc, kv_bf16, pos, position, ws, cp_t, C, cos, sin), the o GEMV plus
// the residual, the gate/up GEMV (RMSNorm prologue) and the down GEMV (SiLU
// prologue) plus the residual. Five launches.
int qt_layer(const QtLayers& w, int l, QtAttn at, cudaStream_t st) {
  const long long hc = w.hc, qw = (w.nq + 2 * w.nkv) * w.hd, aw = w.nq * w.hd;
  const long long gw = 2 * w.inter;
  QT_TRY(qt_gemv({w.h, QT_VEC_RMS, w.in_ln + l * hc, w.eps, (int)hc, (int)qw,
                  w.qkv_q + l * qw * hc, w.qkv_s + l * qw, w.qkv_m + l * qw, w.qkv, 0}, st));
  at.qkv = w.qkv;
  at.q_ln = w.q_ln + (long long)l * w.hd;
  at.k_ln = w.k_ln + (long long)l * w.hd;
  at.nq = w.nq; at.nkv = w.nkv; at.hd = w.hd;
  at.eps = w.eps; at.scale = 1.f / sqrtf((float)w.hd); at.out = w.attn;
  QT_TRY(qt_attention(at, st));
  QT_TRY(qt_gemv({w.attn, QT_VEC_PLAIN, nullptr, w.eps, (int)aw, (int)hc,
                  w.o_q + l * hc * aw, w.o_s + l * hc, w.o_m + l * hc, w.h, 1}, st));
  QT_TRY(qt_gemv({w.h, QT_VEC_RMS, w.post_ln + l * hc, w.eps, (int)hc, (int)gw,
                  w.gu_q + l * gw * hc, w.gu_s + l * gw, w.gu_m + l * gw, w.gu, 0}, st));
  return qt_gemv({w.gu, QT_VEC_SILU, nullptr, w.eps, w.inter, (int)hc,
                  w.dn_q + l * hc * w.inter, w.dn_s + l * hc, w.dn_m + l * hc, w.h, 1}, st);
}

}  // namespace
