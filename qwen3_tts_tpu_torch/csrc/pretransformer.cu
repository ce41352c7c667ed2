// K4: the vocoder's 8-layer causal pre-transformer.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/pretransformer_kernel.py::
// _kernel_packed (wrapper pre_transformer_packed): input_proj; per layer
// RMSNorm -> RoPE attention (16 heads x 64) with LayerScale -> RMSNorm ->
// SwiGLU (512 -> 1024 -> 512) with LayerScale; final norm; output_proj.
//
// What bounds it on the H100: at the main path's shapes (T = 26 or 110
// rows, width 512) the work is ~1.6 / ~6.7 GFLOP per call over ~61 MB of
// bf16 weights (~18 us at 3.35 TB/s; 2 / 7 us of bf16 tensor-core FLOPs).
// At so few rows no phase fills the card, so the time
// goes to the latency of each step: launches, and in one launch the grid
// barriers and each phase's loads.
//
// Two designs, picked by the weights' dtype:
// - bf16 weights (the pipeline's): one persistent cooperative launch,
//   qt_pt_persistent_kernel, at the end of this file (its note there).
// - fp32 weights (the exact parity path): a short sequence of launches per
//   layer (the wrapper in ops/cuda/pretransformer_kernel.py drives them):
//   the shared tiled GEMM (gemm.cuh) with bias / LayerScale-residual
//   epilogues for every projection, and the small kernels below for
//   RMSNorm, rotate-half RoPE (angles computed in fp32 from the position,
//   no permutation matmul), causal attention and SiLU * up. The residual
//   stream and every intermediate stay fp32. Attention handles any T: one
//   warp per (sequence, head, query) with an online softmax over key
//   chunks of 32, so no T x T score matrix exists and no T cap applies.
//
// K4a, the same function over the per-head weight layout: with bf16
// weights the same persistent launch, its GEMM phases reading the per-head
// arrays in place (qt_pt_w_col); with fp32 weights K4's GEMM, RMSNorm and
// launch pattern around a per-(sequence, head) attention kernel. Its note
// is further down.

#include "gemm.cuh"
#include "mma.cuh"
#include "w8a8.cuh"

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
// separate gate / up / down matrices. With bf16 weights it is K4's
// persistent launch (qt_pt_persistent_kernel below, per-head addressing in
// qt_pt_w_col). With fp32 weights the wrapper
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
// all, so this fp32 path is bound by its grid's width, not by bytes.
// ---------------------------------------------------------------------------

constexpr int QT_HA_THREADS = 256, QT_HA_RT = 32, QT_HA_BK = 32;
constexpr int QT_SMEM_MAX = 232448;  // 227 KB a block may opt into on sm_90

template <int HD>
constexpr int qt_ha_base_bytes() {
  return (QT_HA_RT * (QT_HA_BK + 1) + QT_HA_BK * 3 * HD) * (int)sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(QT_HA_THREADS) qt_head_attention_kernel(
    const float* __restrict__ xn, const float* __restrict__ wq, const float* __restrict__ wk,
    const float* __restrict__ wv, const float* __restrict__ inv_freq, float* scratch,
    float* __restrict__ out, int T, int H, int nh, float scale) {
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
        const float* w = which == 0 ? wq : (which == 1 ? wk : wv);
        ws[idx] = k0 + kk < H ? w[woff + (long long)(k0 + kk) * HD + d] : 0.f;
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
int qt_head_attention_launch(const float* xn, const float* wq, const float* wk,
                             const float* wv, const float* inv_freq, float* scratch, float* out,
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
      xn, wq, wk, wv, inv_freq, in_smem ? nullptr : scratch, out, T, H, nh, scale);
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

// K4a's attention block for one layer (fp32 weights): xn [B*T, H] fp32;
// wq/wk/wv the layer's [nh, H, hd] blocks; out [B*T, nh*hd] fp32.
// `scratch` ([B, nh, 3, T, hd + 1] fp32) is read only when T exceeds
// qt_pt_head_store_rows(hd); it may be null otherwise.
extern "C" int qt_pt_head_attention(const float* xn, const float* wq, const float* wk,
                                    const float* wv, const float* inv_freq, float* scratch,
                                    float* out, int B, int T, int H, int nh, int hd,
                                    float scale, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64)
    return qt_head_attention_launch<64>(xn, wq, wk, wv, inv_freq, scratch, out, B, T, H, nh,
                                        scale, st);
  if (hd == 128)
    return qt_head_attention_launch<128>(xn, wq, wk, wv, inv_freq, scratch, out, B, T, H, nh,
                                         scale, st);
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

// ---------------------------------------------------------------------------
// K4 with bf16 weights (the pipeline's): the whole call as ONE persistent
// cooperative launch, qt_pt_persistent_kernel.
//
// One block of PK_NT threads per SM (w8a8.cuh's qt_persistent_grid /
// qt_persistent_launch), phases separated by grid barriers: the input
// projection, then per layer five phases,
//   1. qkv = RMSNorm(h) @ Wqkv               (RMSNorm in the A prologue)
//   2. attention, one item per (sequence, head, 64 query rows)
//   3. h += lsa * (o @ Wo)
//   4. mm = bf16(SiLU(g) * u), [g | u] = RMSNorm(h) @ Wgu
//   5. h += lsm * (mm @ Wd)
// and the output projection of RMSNorm(h): 1 + 5 nl barriers (41 at nl =
// 8), against 75 launches from the host before.
//
// A GEMM phase cuts its output into items of 128 rows (64 where their
// bf16 copy would not fit the work area: a depth of 1024) x 16 columns
// (two groups of 8; in phase 4 the 8 gate columns and the 8 up columns of
// the same channels, so SiLU(g) * u is formed in the epilogue) and deals
// them round-robin to the blocks. An item stages its input rows whole in
// shared memory as bf16 (RMSNorm applied in fp32 first, one warp a row),
// and its [K, 16] weight slice arrives by 16-byte cp.async; the slice of a
// block's first item of the next GEMM phase is requested during its last
// item of this one, so it lands under the barrier (and the attention
// phase). The 16 warps split the item's m16 blocks and its K steps, each
// running mma.sync m16n8k16 (bf16, fp32 accumulators); the partial sums
// meet in shared memory and are added in a fixed order, so a call is
// deterministic. An attention item stages its q rows and the K/V rows (kc
// at a time) in shared memory with RoPE applied, and runs two passes over
// the keys per query (max and sum, then the normalized bf16 weights times
// V), so no T cap applies. Data written inside the launch is read with
// ld.global.cg (L2), weights by cp.async.
//
// K4a runs this kernel too (wk set): its q, k and v sections and its gate
// and up halves come from their own tensors, read in place (qt_pt_w_col).
// A 16-column item lies in one head (hd % 16 == 0), the items, K order and
// roundings are K4's, so on the same weights K4a's output is K4's bit for
// bit.
//
// Numerics, as the JAX kernel (_kernel_packed) at compute_dtype bf16: the
// residual stream, every sum and the softmax stay fp32; each product's
// operands are bf16 (the normed rows, q with its scale, k, v, the softmax
// weights, the attention output, SiLU(g) * u, the weights), and RoPE's
// rotate-half term is taken from bf16 values, as JAX forms it as a product
// with a permutation matrix. pre_transformer_plain mirrors each rounding.
// ---------------------------------------------------------------------------

struct QtPtArgs {
  const void* x;  // [M, lat]
  int x_bf16;
  const __nv_bfloat16 *wi, *wqkv, *wo, *wgu, *wd, *wout;  // [in, out], layers stacked
  // K4a's per-head layout where wk is set: wqkv is wq, and wq, wk, wv are
  // [nl, nh, hid, hd] each; wgu is wg, and wg, wu are [nl, hid, inter] each
  const __nv_bfloat16 *wk, *wv, *wu;
  const float *bi, *ln1, *lsa, *ln2, *lsm, *fnorm, *bout, *inv_freq;
  float* h;             // [M, hid] the residual stream
  float* qkv;           // [M, 3 D] q | k | v before RoPE
  __nv_bfloat16* o;     // [M, D] attention output
  __nv_bfloat16* mm;    // [M, I] SiLU(gate) * up
  void* out;            // [M, lat]
  int out_bf16;
  int B, T, lat, hid, nh, hd, inter, nl;
  float eps, scale;
  int wbuf, work, area, kc;  // bytes of a weight buffer; offset and bytes of the work area;
                             // keys a chunk
};

namespace {

constexpr int PT_QROWS = 64;  // query rows of an attention item
enum { PT_E_BIAS = 0, PT_E_STORE = 1, PT_E_RESID = 2, PT_E_SILU = 3 };

// One GEMM phase: c = epi(A @ w), A from `a` (bf16 or fp32 rows, RMSNorm
// with gain `ln` when set).
struct QtPtGemm {
  const void* a;
  int a_bf16;
  const float* ln;
  const __nv_bfloat16* w;  // [K, N]; or, where w2 is set, see qt_pt_w_col
  const __nv_bfloat16 *w2, *w3;
  int K, N, pair, epi, hd;
  const float* vec;  // bias (BIAS) or LayerScale (RESID)
  void* c;
  int c_bf16;
};

__device__ QtPtGemm qt_pt_gemm_desc(const QtPtArgs& p, int gi) {
  QtPtGemm d{};
  const int D = p.nh * p.hd;
  if (gi == 0) {
    d.a = p.x, d.a_bf16 = p.x_bf16, d.w = p.wi, d.K = p.lat, d.N = p.hid;
    d.epi = PT_E_BIAS, d.vec = p.bi, d.c = p.h;
    return d;
  }
  if (gi == 4 * p.nl + 1) {
    d.a = p.h, d.ln = p.fnorm, d.w = p.wout, d.K = p.hid, d.N = p.lat;
    d.epi = PT_E_BIAS, d.vec = p.bout, d.c = p.out, d.c_bf16 = p.out_bf16;
    return d;
  }
  const int l = (gi - 1) / 4;
  switch ((gi - 1) % 4) {
    case 0:
      d.a = p.h, d.ln = p.ln1 + (long long)l * p.hid;
      if (p.wk) {
        const long long at = (long long)l * p.hid * D;
        d.w = p.wqkv + at, d.w2 = p.wk + at, d.w3 = p.wv + at, d.hd = p.hd;
      } else {
        d.w = p.wqkv + (long long)l * p.hid * 3 * D;
      }
      d.K = p.hid, d.N = 3 * D, d.epi = PT_E_STORE, d.c = p.qkv;
      break;
    case 1:
      d.a = p.o, d.a_bf16 = 1, d.w = p.wo + (long long)l * D * p.hid, d.K = D, d.N = p.hid;
      d.epi = PT_E_RESID, d.vec = p.lsa + (long long)l * p.hid, d.c = p.h;
      break;
    case 2:
      d.a = p.h, d.ln = p.ln2 + (long long)l * p.hid;
      if (p.wk) {
        d.w = p.wgu + (long long)l * p.hid * p.inter, d.w2 = p.wu + (long long)l * p.hid * p.inter;
      } else {
        d.w = p.wgu + (long long)l * p.hid * 2 * p.inter;
      }
      d.K = p.hid, d.N = 2 * p.inter, d.pair = 1, d.epi = PT_E_SILU, d.c = p.mm;
      break;
    default:
      d.a = p.mm, d.a_bf16 = 1, d.w = p.wd + (long long)l * p.inter * p.hid, d.K = p.inter;
      d.N = p.hid, d.epi = PT_E_RESID, d.vec = p.lsm + (long long)l * p.hid, d.c = p.h;
  }
  return d;
}

__device__ __forceinline__ int qt_pt_nitems(const QtPtGemm& d) {
  return d.pair ? d.N / 16 : (d.N + 15) / 16;
}

// Rows of a GEMM item: 128 where their bf16 copy fits the work area, else 64.
__device__ __forceinline__ int qt_pt_bm(const QtPtGemm& d, int area) {
  return 128 * (d.K + 8) * 2 <= area ? 128 : 64;
}

__device__ __forceinline__ int qt_pt_items(const QtPtGemm& d, int M, int area) {
  const int bm = qt_pt_bm(d, area);
  return ((M + bm - 1) / bm) * qt_pt_nitems(d);
}

// Output column of slot j (0..15) of column item nt: two groups of 8, the
// gate and the up columns of the same 8 channels in a paired phase.
__device__ __forceinline__ int qt_pt_col(const QtPtGemm& d, int nt, int j) {
  if (d.pair) return (j >> 3) * (d.N / 2) + nt * 8 + (j & 7);
  return nt * 16 + j;
}

// Where output column col of a phase (one that starts a group of 8) finds
// its weights: row k at the result + k * (*ld), the group's 8 values side by
// side. K4's [K, N] matrix; or K4a's per-head tensors: the q, k and v
// sections (N = 3 D) from w, w2 and w3, column c of a section at
// (c / hd) * K * hd + k * hd + c % hd of [nh, K, hd]; the gate and up
// halves (pair) from w and w2, [K, N / 2] each.
__device__ __forceinline__ const __nv_bfloat16* qt_pt_w_col(const QtPtGemm& d, int col,
                                                           long long* ld) {
  if (!d.w2) {
    *ld = d.N;
    return d.w + col;
  }
  if (d.pair) {
    const int I = d.N / 2;
    *ld = I;
    return col < I ? d.w + col : d.w2 + (col - I);
  }
  const int D = d.N / 3, s = col / D, c = col % D;
  *ld = d.hd;
  return (s == 0 ? d.w : s == 1 ? d.w2 : d.w3) + (long long)(c / d.hd) * d.K * d.hd + c % d.hd;
}

// Column item nt's weight slice [K][16] into `buf` (swizzled: qt_b16_at):
// a thread copies rows of one group of 8 (PK_NT is even).
__device__ void qt_pt_fetch_w(const QtPtGemm& d, int nt, __nv_bfloat16* buf) {
  const int half = threadIdx.x & 1, col = qt_pt_col(d, nt, half * 8);
  const bool ok = col < d.N;  // N % 8 == 0: a group is whole or absent
  long long ld = 0;
  const __nv_bfloat16* src = ok ? qt_pt_w_col(d, col, &ld) : d.w;
  for (int k = threadIdx.x >> 1; k < d.K; k += PK_NT / 2)
    qt_cp16(buf + qt_b16_at(k, half), src + k * ld, ok ? 16 : 0);
  qt_cp_commit();
}

// Request the slice of this block's first item of GEMM phase gi + 1, or
// commit an empty group, so that wait_group 1 always means "all but it".
__device__ void qt_pt_prefetch(const QtPtArgs& p, int gi, int M, unsigned char* smem) {
  if (gi + 1 < 4 * p.nl + 2) {
    const QtPtGemm dn = qt_pt_gemm_desc(p, gi + 1);
    if ((int)blockIdx.x < qt_pt_items(dn, M, p.area)) {
      qt_pt_fetch_w(dn, blockIdx.x % qt_pt_nitems(dn),
                    reinterpret_cast<__nv_bfloat16*>(smem + ((gi + 1) & 1) * p.wbuf));
      return;
    }
  }
  qt_cp_commit();
}

__device__ __forceinline__ void qt_st4_bf16(__nv_bfloat16* dst, float a, float b, float c,
                                            float e) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, e);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = v;
}

// The item's input rows [m0, m0 + nrows) as bf16 into A (row stride
// lda), one warp a row; rows past M are zero.
__device__ void qt_pt_load_a(const QtPtGemm& d, float eps, int m0, int nrows, int M,
                             __nv_bfloat16* A, int lda) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += PK_WARPS) {
    __nv_bfloat16* dst = A + r * lda;
    const long long m = m0 + r;
    if (m >= M) {
      for (int k = lane * 8; k < d.K; k += 256) *reinterpret_cast<uint4*>(dst + k) = uint4{};
    } else if (d.ln) {  // fp32 rows, RMSNorm (K <= 1024: 8 float4 a lane)
      const float* src = reinterpret_cast<const float*>(d.a) + m * d.K;
      float4 v[8];
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = 4 * lane + 128 * j;
        if (k < d.K) {
          v[j] = __ldcg(reinterpret_cast<const float4*>(src + k));
          ss += v[j].x * v[j].x + v[j].y * v[j].y + v[j].z * v[j].z + v[j].w * v[j].w;
        }
      }
      const float rr = rsqrtf(qt_warp_sum(ss) / (float)d.K + eps);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = 4 * lane + 128 * j;
        if (k < d.K) {
          const float4 g = __ldg(reinterpret_cast<const float4*>(d.ln + k));
          qt_st4_bf16(dst + k, v[j].x * rr * g.x, v[j].y * rr * g.y, v[j].z * rr * g.z,
                      v[j].w * rr * g.w);
        }
      }
    } else if (d.a_bf16) {
      const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(d.a) + m * d.K;
      for (int k = lane * 8; k < d.K; k += 256)
        *reinterpret_cast<uint4*>(dst + k) = __ldcg(reinterpret_cast<const uint4*>(src + k));
    } else {
      const float* src = reinterpret_cast<const float*>(d.a) + m * d.K;
      for (int k = lane * 4; k < d.K; k += 128) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src + k));
        qt_st4_bf16(dst + k, v.x, v.y, v.z, v.w);
      }
    }
  }
}

__device__ void qt_pt_gemm_phase(const QtPtArgs& p, int gi, int M, unsigned char* smem) {
  const QtPtGemm d = qt_pt_gemm_desc(p, gi);
  const int bm = qt_pt_bm(d, p.area), nit = qt_pt_nitems(d), items = qt_pt_items(d, M, p.area);
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem + (gi & 1) * p.wbuf);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem + p.work);
  float* red = reinterpret_cast<float*>(smem + p.work);  // over A once the MMAs are done
  const int lda = d.K + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool first = true;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int m0 = (it / nit) * bm, nt = it % nit;
    if (!first) qt_pt_fetch_w(d, nt, wb);  // the first item's slice came a phase ahead
    first = false;
    const int rows = min(bm, M - m0), live = (rows + 15) / 16;  // m16 blocks with rows
    qt_pt_load_a(d, p.eps, m0, live * 16, M, A, lda);
    if (it + (int)gridDim.x >= items) {
      qt_pt_prefetch(p, gi, M, smem);
      qt_cp_wait<1>();
    } else {
      qt_cp_wait<0>();
    }
    __syncthreads();

    // warps: nmb m16 blocks x kp K parts
    const int nmb = live == 1 ? 1 : (live == 2 ? 2 : (live <= 4 ? 4 : 8)), kp = PK_WARPS / nmb;
    const int mb = warp % nmb, part = warp / nmb;
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    if (mb < live) {
      for (int ks = part; ks < d.K / 16; ks += kp) {
        uint32_t af[4], bq[4];
        qt_ldsm_a(af, A + mb * 16 * lda + ks * 16, lda);
        qt_ldsm_b16(bq, wb, ks * 16);
        qt_mma(c0, af, bq[0], bq[1]);
        qt_mma(c1, af, bq[2], bq[3]);
      }
    }
    __syncthreads();  // A is read; the partial sums take its place
    if (mb < live) {
      float* rw = red + warp * 256;  // [16 rows][16 columns]
      const int g = lane >> 2, t2 = (lane & 3) * 2;
      rw[g * 16 + t2] = c0[0], rw[g * 16 + t2 + 1] = c0[1];
      rw[(g + 8) * 16 + t2] = c0[2], rw[(g + 8) * 16 + t2 + 1] = c0[3];
      rw[g * 16 + 8 + t2] = c1[0], rw[g * 16 + 9 + t2] = c1[1];
      rw[(g + 8) * 16 + 8 + t2] = c1[2], rw[(g + 8) * 16 + 9 + t2] = c1[3];
    }
    __syncthreads();
    auto total = [&](int r, int j) {  // the K parts in a fixed order
      float s = 0.f;
      for (int q = 0; q < kp; ++q) s += red[(q * nmb + (r >> 4)) * 256 + (r & 15) * 16 + j];
      return s;
    };
    if (d.epi == PT_E_SILU) {
      const int I = d.N / 2;
      for (int e = tid; e < rows * 8; e += PK_NT) {
        const int r = e >> 3, j = e & 7;
        const float g = total(r, j), u = total(r, j + 8);
        reinterpret_cast<__nv_bfloat16*>(d.c)[(long long)(m0 + r) * I + nt * 8 + j] =
            qt_bf16(g / (1.f + expf(-g)) * u);
      }
    } else {
      for (int e = tid; e < rows * 16; e += PK_NT) {
        const int r = e >> 4, j = e & 15, col = qt_pt_col(d, nt, j);
        if (col >= d.N) continue;
        const long long at = (long long)(m0 + r) * d.N + col;
        const float v = total(r, j);
        if (d.epi == PT_E_BIAS) {
          qt_st(d.c, at, v + d.vec[col], d.c_bf16);
        } else if (d.epi == PT_E_STORE) {
          reinterpret_cast<float*>(d.c)[at] = v;
        } else {
          float* hp = reinterpret_cast<float*>(d.c);
          hp[at] = __ldcg(hp + at) + d.vec[col] * v;
        }
      }
    }
    __syncthreads();  // the work area is free for the next item
  }
  if (first) qt_pt_prefetch(p, gi, M, smem);  // no item here: still fetch the next slice
}

// Element d of a q or k row (`x` = the head's pre-RoPE row) after RoPE at
// position t, its rotate-half term from bf16 values.
__device__ __forceinline__ float qt_pt_rope(const float* x, int d, int t, int half,
                                            const float* inv_freq) {
  const int j = d < half ? d : d - half;
  const float ang = (float)t * inv_freq[j];
  const float rot = d < half ? -__ldcg(x + d + half) : __ldcg(x + d - half);
  return __ldcg(x + d) * cosf(ang) + qt_round_bf16(rot) * sinf(ang);
}

// Causal attention, o = softmax(q k^T) v with q carrying its scale: an
// item is (sequence, head, 64 query rows), 4 rows a warp; keys kc at a time.
__device__ void qt_pt_attention_phase(const QtPtArgs& p, unsigned char* smem) {
  const int D = p.nh * p.hd, hd = p.hd, half = hd / 2, ld = hd + 1, T = p.T, kc = p.kc;
  const int nq = (T + PT_QROWS - 1) / PT_QROWS;
  float* sq = reinterpret_cast<float*>(smem + p.work);  // [PT_QROWS][ld]
  float* sk = sq + PT_QROWS * ld;                        // [kc][ld]
  float* sv = sk + kc * ld;                              // [kc][ld]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int it = blockIdx.x; it < p.B * p.nh * nq; it += gridDim.x) {
    const int b = it / (p.nh * nq), hh = (it / nq) % p.nh, q0 = (it % nq) * PT_QROWS;
    const float* base = p.qkv + (long long)b * T * 3 * D;
    const int qn = min(PT_QROWS, T - q0);
    __syncthreads();  // the previous item's readers are done
    for (int e = tid; e < qn * hd; e += PK_NT) {
      const int r = e / hd, dd = e % hd;
      const float* row = base + (long long)(q0 + r) * 3 * D + hh * hd;
      sq[r * ld + dd] = qt_round_bf16(qt_pt_rope(row, dd, q0 + r, half, p.inv_freq) * p.scale);
    }
    float mx[4], l[4], o[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      mx[u] = -1e30f, l[u] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) o[u][r] = 0.f;
    }
    const int nkc = (q0 + qn - 1) / kc + 1;
    int staged = -1;
    for (int pass = 0; pass < 2; ++pass) {
      for (int c = 0; c < nkc; ++c) {
        const int k0 = c * kc;
        if (staged != c) {
          __syncthreads();
          const int kn = min(kc, T - k0);
          for (int e = tid; e < kn * hd; e += PK_NT) {
            const int r = e / hd, dd = e % hd;
            const float* row = base + (long long)(k0 + r) * 3 * D + hh * hd;
            sk[r * ld + dd] = qt_round_bf16(qt_pt_rope(row + D, dd, k0 + r, half, p.inv_freq));
            sv[r * ld + dd] = qt_round_bf16(__ldcg(row + 2 * D + dd));
          }
          __syncthreads();
          staged = c;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = q0 + warp + 16 * u;  // warp-uniform
          if (i >= q0 + qn) continue;
          const int jend = min(k0 + kc, i + 1);
          const float* qr = sq + (i - q0) * ld;
          for (int j0 = k0; j0 < jend; j0 += 32) {
            const int j = j0 + lane;
            float s = -1e30f;
            if (j < jend) {
              const float* kr = sk + (j - k0) * ld;
              float dot = 0.f;
              for (int dd = 0; dd < hd; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
              s = dot;
            }
            if (pass == 0) {
              const float nm = fmaxf(mx[u], qt_warp_max(s));
              l[u] = l[u] * expf(mx[u] - nm) + qt_warp_sum(j < jend ? expf(s - nm) : 0.f);
              mx[u] = nm;
            } else {
              const float pj = j < jend ? qt_round_bf16(expf(s - mx[u]) / l[u]) : 0.f;
              const int nj = min(32, jend - j0);
              for (int w = 0; w < nj; ++w) {
                const float pw = __shfl_sync(0xffffffffu, pj, w);
                const float* vr = sv + (j0 + w - k0) * ld;
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  if (lane + 32 * r < hd) o[u][r] = fmaf(pw, vr[lane + 32 * r], o[u][r]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = q0 + warp + 16 * u;
      if (i >= q0 + qn) continue;
      __nv_bfloat16* orow = p.o + ((long long)b * T + i) * D + hh * hd;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (lane + 32 * r < hd) orow[lane + 32 * r] = qt_bf16(o[u][r]);
    }
  }
}

__global__ void __launch_bounds__(PK_NT, 1) qt_pt_persistent_kernel(const QtPtArgs p) {
  extern __shared__ __align__(128) unsigned char qt_pt_smem[];
  const int M = p.B * p.T;
  const QtPtGemm d0 = qt_pt_gemm_desc(p, 0);
  if ((int)blockIdx.x < qt_pt_items(d0, M, p.area))
    qt_pt_fetch_w(d0, blockIdx.x % qt_pt_nitems(d0),
                  reinterpret_cast<__nv_bfloat16*>(qt_pt_smem));
  qt_pt_gemm_phase(p, 0, M, qt_pt_smem);
  for (int l = 0; l < p.nl; ++l) {
    qt_grid_sync();
    qt_pt_gemm_phase(p, 1 + 4 * l, M, qt_pt_smem);
    qt_grid_sync();
    qt_pt_attention_phase(p, qt_pt_smem);
    for (int k = 2; k <= 4; ++k) {
      qt_grid_sync();
      qt_pt_gemm_phase(p, k + 4 * l, M, qt_pt_smem);
    }
  }
  qt_grid_sync();
  qt_pt_gemm_phase(p, 4 * p.nl + 1, M, qt_pt_smem);
}

}  // namespace

extern "C" int qt_pt_persistent_grid(int smem, int* blocks) {
  return qt_persistent_grid(qt_pt_persistent_kernel, smem, blocks);
}

// One call of the bf16 pre-transformer: a cooperative launch of `grid`
// blocks with `smem` bytes of dynamic shared memory (the plan of
// ops/cuda/pretransformer_kernel.py::persistent_layout).
extern "C" int qt_pt_persistent(const QtPtArgs* args, int grid, int smem, void* stream) {
  if (args->B <= 0 || args->T <= 0) return 0;
  QtPlan plan{};
  plan.grid = grid;
  plan.smem = smem;
  return qt_persistent_launch(qt_pt_persistent_kernel, args, plan, stream);
}
