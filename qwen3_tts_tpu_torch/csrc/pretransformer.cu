// K4: the vocoder's 8-layer causal pre-transformer.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/pretransformer_kernel.py::
// _kernel_packed (wrapper pre_transformer_packed): input_proj; per layer
// RMSNorm -> RoPE attention (16 heads x 64) with LayerScale -> RMSNorm ->
// SwiGLU (512 -> 1024 -> 512) with LayerScale; final norm; output_proj.
//
// What bounds it on the H100: at the main path's shapes (T = 26 or 110
// rows, width 512) the work is ~1.6 / ~6.7 GFLOP per call over ~61 MB of
// bf16 weights (read in ~18 us at 3.35 TB/s), so a simple kernel is bound
// by its own FMA rate and by the number of launches, not by device memory.
//
// Design: a short sequence of hand-written launches per layer (the wrapper
// in ops/cuda/pretransformer_kernel.py drives them): the shared tiled GEMM
// (gemm.cuh) with bias / LayerScale-residual epilogues for every
// projection, and the small kernels below for RMSNorm, rotate-half RoPE
// (angles computed in fp32 from the position, no permutation matmul),
// causal attention and SiLU * up. The residual stream and every
// intermediate stay fp32; weights are fp32 or bf16. Attention handles any
// T: one warp per (sequence, head, query) with an online softmax over key
// chunks of 32, so no T x T score matrix exists and no T cap applies.
//
// K4a, the same function over the per-head weight layout, shares the GEMM,
// RMSNorm and launch pattern and adds a per-(sequence, head) attention
// kernel; its note is further down.

#include "gemm.cuh"

namespace {

// y[m, :] = x * rsqrt(mean(x^2) + eps) * w   (fp32 in, fp32 out)
__global__ void qt_rmsnorm_kernel(const float* __restrict__ x,
                                  const float* __restrict__ w,
                                  float* __restrict__ y, int H, float eps) {
  __shared__ float sh[32];
  const long long row = blockIdx.x;
  const float* xr = x + row * H;
  float ss = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) ss += xr[i] * xr[i];
  ss = qt_block_sum(ss, sh);
  const float r = rsqrtf(ss / (float)H + eps);
  for (int i = threadIdx.x; i < H; i += blockDim.x) y[row * H + i] = xr[i] * r * w[i];
}

// In-place rotate-half RoPE on the q and k sections of qkv [B*T, 3*nh*hd].
__global__ void qt_rope_kernel(float* __restrict__ qkv, const float* __restrict__ inv_freq,
                               int rows, int T, int nh, int hd) {
  const int half = hd / 2;
  const long long total = (long long)rows * 2 * nh * half;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % half);
  const long long rest = idx / half;
  const int head = (int)(rest % (2 * nh));  // q heads then k heads
  const long long m = rest / (2 * nh);
  const int t = (int)(m % T);
  const float ang = (float)t * inv_freq[j];
  const float c = cosf(ang), s = sinf(ang);
  float* p = qkv + m * (3LL * nh * hd) + (long long)head * hd;
  const float x1 = p[j], x2 = p[j + half];
  p[j] = x1 * c - x2 * s;
  p[j + half] = x2 * c + x1 * s;
}

// Causal softmax attention. qkv [B*T, 3*D] (D = nh*hd), out [B*T, D].
// One warp per (sequence b, head h, query i); hd <= 128, hd % 32 == 0.
__global__ void qt_causal_attention_kernel(const float* __restrict__ qkv,
                                           float* __restrict__ out, int B, int T,
                                           int nh, int hd, float scale) {
  extern __shared__ float qsh[];  // [warps per block][hd]
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long long task = (long long)blockIdx.x * (blockDim.x >> 5) + wib;
  if (task >= (long long)B * nh * T) return;
  const int i = (int)(task % T);
  const int h = (int)((task / T) % nh);
  const int b = (int)(task / ((long long)T * nh));
  const int D = nh * hd;
  const long long ld = 3LL * D;
  const float* base = qkv + (long long)b * T * ld;
  float* q = qsh + wib * hd;
  for (int d = lane; d < hd; d += 32) q[d] = base[(long long)i * ld + h * hd + d];
  __syncwarp();

  const int nd = hd / 32;  // dims owned by this lane: lane + 32 * r
  float o[4] = {0.f, 0.f, 0.f, 0.f};
  float mx = -1e30f, sum = 0.f;
  for (int j0 = 0; j0 <= i; j0 += 32) {
    const int j = j0 + lane;
    float sc = -1e30f;
    if (j <= i) {
      const float* kr = base + (long long)j * ld + D + h * hd;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(q[d], kr[d], dot);
      sc = dot * scale;
    }
    const float cmax = qt_warp_max(sc);
    const float nmx = fmaxf(mx, cmax);
    const float corr = expf(mx - nmx);
    const float p = (j <= i) ? expf(sc - nmx) : 0.f;
    sum = sum * corr + qt_warp_sum(p);
#pragma unroll
    for (int r = 0; r < 4; ++r) o[r] *= corr;
    const int nj = min(32, i - j0 + 1);
    for (int jj = 0; jj < nj; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      const float* vr = base + (long long)(j0 + jj) * ld + 2 * D + h * hd;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r < nd) o[r] = fmaf(pj, vr[lane + 32 * r], o[r]);
    }
    mx = nmx;
  }
  const float inv = 1.f / sum;
  float* orow = out + ((long long)b * T + i) * D + h * hd;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (r < nd) orow[lane + 32 * r] = o[r] * inv;
}

// y[m, c] = silu(gu[m, c]) * gu[m, I + c]   (gu [rows, 2I] fp32)
__global__ void qt_silu_mul_kernel(const float* __restrict__ gu, float* __restrict__ y,
                                   long long rows, int I) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * I) return;
  const long long m = idx / I;
  const int c = (int)(idx % I);
  const float g = gu[m * 2 * I + c];
  y[idx] = g / (1.f + expf(-g)) * gu[m * 2 * I + I + c];
}

// ---------------------------------------------------------------------------
// K4a: the per-head variant.
//
// Replaces qwen3_tts_tpu/ops/pallas/pretransformer_kernel.py::_kernel
// (wrapper pre_transformer_fused): the same function as K4 over the
// per-head weight layout wq/wk/wv [nl, nh, H, hd], wo [nl, nh, hd, H] and
// separate gate / up / down matrices. The wrapper
// (ops/cuda/pretransformer_kernel.py::pre_transformer_fused_kernel) runs
// per layer: RMSNorm, qt_head_attention_kernel, the o-projection as one
// GEMM over the heads' outputs laid side by side (its K loop walks the
// heads in order, so the sum over heads has a fixed order and no atomics),
// RMSNorm, gate and up GEMMs, SiLU * up, down GEMM.
//
// qt_head_attention_kernel: one block per (batch row, head). Phase 1 forms
// the head's q, k, v [T, HD] from its own weights (a 32-row x 3HD tile per
// step over K chunks of 32, weights staged in shared memory), applies
// rotate-half RoPE to q and k in registers (each thread holds both halves
// of its pairs; no permutation matmul), and stores them in shared memory:
// 3 x T x (HD + 1) fp32, 85.8 KB at T = 110. A T whose q/k/v do not fit
// (above 261 rows at HD = 64) stores them in a global scratch of the
// block's own instead, so no T cap applies. Phase 2 is K4's attention: one
// warp per query, an online softmax over key chunks of 32 (one key per
// lane), P.V accumulated per lane over HD / 32 dims. Bound on the H100: at
// T = 110 a block does 21.6 MFLOP of fp32 FMA on one SM, 16 or 32 blocks in
// all, so this first version is bound by its grid's width, not by bytes.
// ---------------------------------------------------------------------------

constexpr int QT_HA_THREADS = 256, QT_HA_RT = 32, QT_HA_BK = 32;
constexpr int QT_SMEM_MAX = 232448;  // 227 KB a block may opt into on sm_90

template <int HD>
constexpr int qt_ha_base_bytes() {
  return (QT_HA_RT * (QT_HA_BK + 1) + QT_HA_BK * 3 * HD) * (int)sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(QT_HA_THREADS) qt_head_attention_kernel(
    const float* __restrict__ xn, const void* __restrict__ wq, const void* __restrict__ wk,
    const void* __restrict__ wv, int w_bf16, const float* __restrict__ inv_freq,
    float* scratch, float* __restrict__ out, int T, int H, int nh, float scale) {
  constexpr int NC = 3 * HD / 32;  // output columns per lane: q, k, v sections
  constexpr int HC = HD / 32;      // columns per lane in one section
  constexpr int LD = HD + 1;       // row stride of the q/k/v store (no bank conflicts)
  extern __shared__ float smem[];
  float* xs = smem;                                    // [RT][BK + 1]
  float* ws = xs + QT_HA_RT * (QT_HA_BK + 1);          // [BK][3 * HD]
  const int b = blockIdx.x, j = blockIdx.y;
  const long long tstore = 3LL * T * LD;
  float* store = scratch ? scratch + ((long long)b * nh + j) * tstore
                         : ws + QT_HA_BK * 3 * HD;     // [3][T][LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xb = xn + (long long)b * T * H;
  const long long woff = (long long)j * H * HD;        // head j's [H, HD] block

  // Phase 1: q/k/v rows, RoPE on q and k
  for (int r0 = 0; r0 < T; r0 += QT_HA_RT) {
    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    for (int k0 = 0; k0 < H; k0 += QT_HA_BK) {
      for (int idx = tid; idx < QT_HA_RT * QT_HA_BK; idx += QT_HA_THREADS) {
        const int r = idx / QT_HA_BK, kk = idx % QT_HA_BK;
        xs[r * (QT_HA_BK + 1) + kk] =
            (r0 + r < T && k0 + kk < H) ? xb[(long long)(r0 + r) * H + k0 + kk] : 0.f;
      }
      for (int idx = tid; idx < QT_HA_BK * 3 * HD; idx += QT_HA_THREADS) {
        const int kk = idx / (3 * HD), col = idx % (3 * HD);
        const int which = col / HD, d = col % HD;
        const void* w = which == 0 ? wq : (which == 1 ? wk : wv);
        ws[idx] = k0 + kk < H ? qt_ld(w, woff + (long long)(k0 + kk) * HD + d, w_bf16) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < QT_HA_BK; ++kk) {
        float a[4], wv_[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[(warp * 4 + i) * (QT_HA_BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) wv_[c] = ws[kk * 3 * HD + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(a[i], wv_[c], acc[i][c]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + warp * 4 + i;
      if (t >= T) continue;
#pragma unroll
      for (int sec = 0; sec < 2; ++sec) {  // q, k: column c pairs with c + HC / 2
#pragma unroll
        for (int c = 0; c < HC / 2; ++c) {
          const int p = lane + 32 * c;  // < HD / 2
          const float ang = (float)t * inv_freq[p];
          const float cs = cosf(ang), sn = sinf(ang);
          const float x1 = acc[i][sec * HC + c], x2 = acc[i][sec * HC + c + HC / 2];
          acc[i][sec * HC + c] = x1 * cs - x2 * sn;
          acc[i][sec * HC + c + HC / 2] = x2 * cs + x1 * sn;
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int which = c / HC, d = lane + 32 * (c % HC);
        store[(long long)which * T * LD + (long long)t * LD + d] = acc[i][c];
      }
    }
  }
  __syncthreads();

  // Phase 2: causal softmax attention, one warp per query
  const float* qs = store;
  const float* ks = store + (long long)T * LD;
  const float* vs = store + 2LL * T * LD;
  const int D = nh * HD;
  for (int i = warp; i < T; i += QT_HA_THREADS / 32) {
    const float* q = qs + (long long)i * LD;
    float o[HC];
#pragma unroll
    for (int r = 0; r < HC; ++r) o[r] = 0.f;
    float mx = -1e30f, sum = 0.f;
    for (int j0 = 0; j0 <= i; j0 += 32) {
      const int jj = j0 + lane;
      float sc = -1e30f;
      if (jj <= i) {
        const float* kr = ks + (long long)jj * LD;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kr[d], dot);
        sc = dot * scale;
      }
      const float nmx = fmaxf(mx, qt_warp_max(sc));
      const float corr = expf(mx - nmx);
      const float p = (jj <= i) ? expf(sc - nmx) : 0.f;
      sum = sum * corr + qt_warp_sum(p);
#pragma unroll
      for (int r = 0; r < HC; ++r) o[r] *= corr;
      const int nj = min(32, i - j0 + 1);
      for (int u = 0; u < nj; ++u) {
        const float pu = __shfl_sync(0xffffffffu, p, u);
        const float* vr = vs + (long long)(j0 + u) * LD;
#pragma unroll
        for (int r = 0; r < HC; ++r) o[r] = fmaf(pu, vr[lane + 32 * r], o[r]);
      }
      mx = nmx;
    }
    const float inv = 1.f / sum;
    float* orow = out + ((long long)b * T + i) * D + (long long)j * HD;
#pragma unroll
    for (int r = 0; r < HC; ++r) orow[lane + 32 * r] = o[r] * inv;
  }
}

// y[m] = silu(g[m]) * u[m]   (fp32, separate gate and up buffers)
__global__ void qt_silu_mul2_kernel(const float* __restrict__ g, const float* __restrict__ u,
                                    float* __restrict__ y, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float v = g[idx];
  y[idx] = v / (1.f + expf(-v)) * u[idx];
}

template <int HD>
int qt_head_attention_launch(const float* xn, const void* wq, const void* wk, const void* wv,
                             int w_bf16, const float* inv_freq, float* scratch, float* out,
                             int B, int T, int H, int nh, float scale, cudaStream_t st) {
  const long long store = 3LL * T * (HD + 1) * sizeof(float);
  const long long base = qt_ha_base_bytes<HD>();
  const bool in_smem = base + store <= QT_SMEM_MAX;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = (int)(in_smem ? base + store : base);
  cudaError_t e = cudaFuncSetAttribute(qt_head_attention_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  qt_head_attention_kernel<HD><<<dim3(B, nh), QT_HA_THREADS, bytes, st>>>(
      xn, wq, wk, wv, w_bf16, inv_freq, in_smem ? nullptr : scratch, out, T, H, nh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qt_pt_gemm(const QtGemmArgs* g, void* stream) {
  return qt_gemm_launch<false, false>(g, stream);
}

extern "C" int qt_pt_rmsnorm(const float* x, const float* w, float* y, int rows, int H,
                             float eps, void* stream) {
  if (rows <= 0) return 0;
  qt_rmsnorm_kernel<<<rows, 256, 0, (cudaStream_t)stream>>>(x, w, y, H, eps);
  return (int)cudaGetLastError();
}

extern "C" int qt_pt_rope(float* qkv, const float* inv_freq, int rows, int T, int nh,
                          int hd, void* stream) {
  const long long total = (long long)rows * nh * hd;  // = rows * 2nh * hd/2
  if (total <= 0) return 0;
  const int blocks = (int)((total + 255) / 256);
  qt_rope_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(qkv, inv_freq, rows, T, nh, hd);
  return (int)cudaGetLastError();
}

extern "C" int qt_pt_attention(const float* qkv, float* out, int B, int T, int nh, int hd,
                               float scale, void* stream) {
  if (hd % 32 != 0 || hd > 128) return (int)cudaErrorInvalidValue;
  const long long tasks = (long long)B * nh * T;
  if (tasks <= 0) return 0;
  const int warps = 8;
  const int blocks = (int)((tasks + warps - 1) / warps);
  qt_causal_attention_kernel<<<blocks, warps * 32, warps * hd * sizeof(float),
                               (cudaStream_t)stream>>>(qkv, out, B, T, nh, hd, scale);
  return (int)cudaGetLastError();
}

extern "C" int qt_pt_silu_mul(const float* gu, float* y, long long rows, int I,
                              void* stream) {
  const long long total = rows * I;
  if (total <= 0) return 0;
  qt_silu_mul_kernel<<<(int)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      gu, y, rows, I);
  return (int)cudaGetLastError();
}

// K4a's attention block for one layer: xn [B*T, H] fp32; wq/wk/wv the
// layer's [nh, H, hd] blocks (fp32 or bf16); out [B*T, nh*hd] fp32.
// `scratch` ([B, nh, 3, T, hd + 1] fp32) is read only when T exceeds
// qt_pt_head_store_rows(hd); it may be null otherwise.
extern "C" int qt_pt_head_attention(const float* xn, const void* wq, const void* wk,
                                    const void* wv, int w_bf16, const float* inv_freq,
                                    float* scratch, float* out, int B, int T, int H, int nh,
                                    int hd, float scale, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64)
    return qt_head_attention_launch<64>(xn, wq, wk, wv, w_bf16, inv_freq, scratch, out, B, T,
                                        H, nh, scale, st);
  if (hd == 128)
    return qt_head_attention_launch<128>(xn, wq, wk, wv, w_bf16, inv_freq, scratch, out, B,
                                         T, H, nh, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The most rows whose q/k/v qt_pt_head_attention keeps in shared memory.
extern "C" int qt_pt_head_store_rows(int hd) {
  if (hd == 64) return (QT_SMEM_MAX - qt_ha_base_bytes<64>()) / (3 * 65 * (int)sizeof(float));
  if (hd == 128)
    return (QT_SMEM_MAX - qt_ha_base_bytes<128>()) / (3 * 129 * (int)sizeof(float));
  return 0;
}

extern "C" int qt_pt_silu_mul2(const float* g, const float* u, float* y, long long n,
                               void* stream) {
  if (n <= 0) return 0;
  qt_silu_mul2_kernel<<<(int)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(g, u, y, n);
  return (int)cudaGetLastError();
}
