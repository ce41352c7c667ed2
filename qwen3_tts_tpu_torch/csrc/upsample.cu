// K5: one ConvNeXt-upsample stage of the vocoder.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/upsample_kernel.py::
// _stage_kernel (wrapper upsample_stage_fused): k=2 stride-2 transposed
// conv, causal depthwise k=7 conv, LayerNorm(1e-6), pointwise x4 with exact
// GELU, pointwise back, gamma, residual; the last stage also applies the
// SEANet initial_conv (k=7, 1024 -> 1536).
//
// What bounds it on the H100: per stage call, ~20 MB (first stage) and
// ~42 MB (second stage, with the initial conv) of bf16 weights, ~6 and
// ~13 us at 3.35 TB/s, against ~1.3 / ~4 GFLOP at T = 26 and ~5.5 / ~18
// GFLOP at T = 110 (1.3-18 us of bf16 tensor-core FLOPs). At 52-440 rows
// no one product fills the card, so the time goes to the latency of each
// step: launches, phases, and each block's weight stream.
//
// Two designs, picked by the weights' dtype:
// - bf16 weights (the pipeline's): one persistent cooperative launch,
//   qt_up_persistent_kernel, at the end of this file (its note there).
// - fp32 weights (the exact parity path): a launch sequence driven by
//   ops/cuda/upsample_kernel.py: the transposed conv is one GEMM whose
//   [T, 2C] output IS the interleaved [2T, C] sequence in memory (column
//   half p holds output phase p), so no interleave step exists;
//   qt_dwconv_layernorm_kernel below does the causal depthwise taps and
//   the LayerNorm of one row per block; the pointwise GEMMs carry bias +
//   erff GELU and bias + gamma-scaled residual in their epilogues; the
//   initial conv is the shared GEMM with a 7-tap causal prologue. Every
//   GEMM is the fp32 FMA tile of gemm.cuh; intermediates are fp32.

#include "gemm.cuh"
#include "mma.cuh"
#include "w8a8.cuh"

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

// ---------------------------------------------------------------------------
// K5 with bf16 weights (the pipeline's): the whole stage as ONE persistent
// cooperative launch, qt_up_persistent_kernel.
//
// One block of PK_NT threads per SM (w8a8.cuh's qt_persistent_grid /
// qt_persistent_launch), phases separated by grid barriers:
//   0. (x in fp32 only) xb = bf16(x)
//   1. up:   z = xb @ up_w + up_b          fp32 [BT, 2C] == [2BT, C]
//   2. dwln: g = bf16(LayerNorm(dw_b + sum_j dw[j] z[m - 6 + j]))
//   3. pw1:  a = bf16(gelu(g @ pw1_w + pw1_b))      (exact erff)
//   4. pw2:  o = z + gamma (a @ pw2_w + pw2_b)      x's dtype, or bf16(o)
//            on the last stage, whose
//   5. ic:   out = ic_b + sum_j bf16(o)[m - 6 + j] @ ic_w[j]
// where taps before the start of a sequence of 2T rows read 0: 3-4
// barriers a call (one more for fp32 x), against 4-5 launches before.
//
// A GEMM phase cuts its output into tiles of 64 or 128 rows (the plan's
// bm, 64 where M <= 64) x 64 columns, and each tile's K range into ks
// equal runs of 64-deep steps, so that tiles x ks items fill the grid
// (ops/cuda/upsample_kernel.py::split_k). Items are dealt round-robin,
// tiles of one column slice next to each other, so that blocks that share
// a weight slice read it together. An item streams its A rows and its
// [64, 64] weight tiles by 16-byte cp.async through a 4-stage ring (the
// initial conv's A rows are the causal taps of bf16(o), zero-filled before
// a sequence's start); each of the 16 warps computes a (bm / 4) x 16
// sub-tile with mma.sync m16n8k16 (bf16 operands, fp32 accumulators, A by
// ldmatrix, B by ldmatrix.trans) and skips m16 blocks past M. With ks > 1
// an item writes its fp32 partial sums, and the last of the tile's ks
// items to arrive (an integer counter per tile, reset by that block, so
// all counters are 0 between launches) adds the ks partials in the order
// 0..ks-1 and applies the epilogue: a fixed order, no float atomics, so a
// call is deterministic. dwln is one warp per row, rows dealt across the
// blocks first, z read from L2. A block's first weight tiles of the next
// GEMM phase are requested once its last item of this one has left the
// ring, so they land under the epilogue and the barrier. Data written
// inside the launch is read with ld.global.cg or cp.async.cg (L2).
//
// Numerics, as the JAX kernel (_stage_kernel) at compute_dtype bf16: x, g,
// a and, on the last stage, o are rounded to bf16 before their products;
// z, the LayerNorm statistics and every sum stay fp32; the output is cast
// to x's dtype. upsample_stage_plain mirrors each rounding.
// ---------------------------------------------------------------------------

struct QtUpArgs {
  const void* x;  // [B T, C]
  int x_bf16;
  __nv_bfloat16* xb;  // [B T, C] bf16(x) when x is fp32, else null
  const __nv_bfloat16 *up_w, *pw1_w, *pw2_w, *ic_w;  // [K, N]; ic_w null without the fold
  const float *up_b, *dw, *dw_b, *ln_w, *ln_b, *pw1_b, *pw2_b, *gamma, *ic_b;
  float* z;           // [2 B T, C]
  __nv_bfloat16* g;   // [2 B T, C]
  __nv_bfloat16* a;   // [2 B T, I]
  __nv_bfloat16* ob;  // [2 B T, C] bf16(o), the initial conv's operand (fold only)
  void* out;          // [2 B T, C] or [2 B T, Cic]
  int out_bf16;
  float* part;  // split-K partial sums
  int* cnt;     // per-tile arrival counters, 0 between launches
  unsigned long long* stamps;  // null, or block 0's %globaltimer at each phase boundary
  int B, T, C, I, Cic;
  int bm[4], ks[4];  // tile rows and K runs of the GEMM phases up, pw1, pw2, ic
};

namespace {

constexpr int UP_BN = 64, UP_BK = 64, UP_LD = 72, UP_STAGES = 4, UP_BMAX = 128;
constexpr int UP_A_ST = UP_BMAX * UP_LD, UP_W_ST = UP_BK * UP_LD;  // elements a stage
enum { UP_E_BIAS = 0, UP_E_GELU = 1, UP_E_RES = 2 };

// One GEMM phase: c = epi(A @ w), A(m, k) with k = tap * lda + c reading
// row m - (taps - 1 - tap) of `a` (0 before the start of a sequence of
// `seq` rows).
struct QtUpGemm {
  const __nv_bfloat16* a;
  int lda, taps, seq;
  const __nv_bfloat16* w;
  int M, K, N, bm, ks, epi;
  const float *bias, *gamma, *res;
  void* c;
  int c_bf16;
};

__device__ QtUpGemm qt_up_gemm_desc(const QtUpArgs& p, int gi) {
  QtUpGemm d{};
  const int M = 2 * p.B * p.T;
  d.taps = 1, d.seq = M, d.M = M, d.bm = p.bm[gi], d.ks = p.ks[gi], d.epi = UP_E_BIAS;
  switch (gi) {
    case 0:
      d.a = p.xb ? p.xb : reinterpret_cast<const __nv_bfloat16*>(p.x);
      d.lda = p.C, d.w = p.up_w, d.M = p.B * p.T, d.seq = d.M, d.K = p.C, d.N = 2 * p.C;
      d.bias = p.up_b, d.c = p.z;
      break;
    case 1:
      d.a = p.g, d.lda = p.C, d.w = p.pw1_w, d.K = p.C, d.N = p.I;
      d.epi = UP_E_GELU, d.bias = p.pw1_b, d.c = p.a, d.c_bf16 = 1;
      break;
    case 2:
      d.a = p.a, d.lda = p.I, d.w = p.pw2_w, d.K = p.I, d.N = p.C;
      d.epi = UP_E_RES, d.bias = p.pw2_b, d.gamma = p.gamma, d.res = p.z;
      d.c = p.ic_w ? (void*)p.ob : p.out, d.c_bf16 = p.ic_w ? 1 : p.out_bf16;
      break;
    default:
      d.a = p.ob, d.lda = p.C, d.taps = 7, d.seq = 2 * p.T, d.w = p.ic_w, d.K = 7 * p.C;
      d.N = p.Cic, d.bias = p.ic_b, d.c = p.out, d.c_bf16 = p.out_bf16;
  }
  return d;
}

struct QtUpItem {
  int tile, split, m0, n0, k0, nst;  // k-steps [k0, k0 + nst) of UP_BK
};

__device__ __forceinline__ int qt_up_mtiles(const QtUpGemm& d) { return (d.M + d.bm - 1) / d.bm; }

__device__ __forceinline__ int qt_up_items(const QtUpGemm& d) {
  return qt_up_mtiles(d) * ((d.N + UP_BN - 1) / UP_BN) * d.ks;
}

// Item `it`: tile it % tiles (its row tile first, so the tiles of one
// column slice are dealt next to each other), K run it / tiles.
__device__ QtUpItem qt_up_item(const QtUpGemm& d, int it) {
  const int mt = qt_up_mtiles(d), tiles = mt * ((d.N + UP_BN - 1) / UP_BN);
  const int steps = (d.K + UP_BK - 1) / UP_BK;
  QtUpItem r;
  r.tile = it % tiles, r.split = it / tiles;
  r.m0 = (r.tile % mt) * d.bm, r.n0 = (r.tile / mt) * UP_BN;
  r.k0 = r.split * steps / d.ks;
  r.nst = (r.split + 1) * steps / d.ks - r.k0;
  return r;
}

// The weight tile of k-step `ks` into ring slot `slot` (one chunk a thread).
__device__ __forceinline__ void qt_up_fetch_w(const QtUpGemm& d, int n0, int ks, int slot,
                                              __nv_bfloat16* W) {
  for (int idx = threadIdx.x; idx < UP_BK * 8; idx += PK_NT) {
    const int r = idx >> 3, ch = idx & 7, k = ks * UP_BK + r, n = n0 + ch * 8;
    const bool ok = k < d.K && n < d.N;  // K, N % 8 == 0: a chunk is whole or absent
    qt_cp16(W + slot * UP_W_ST + r * UP_LD + ch * 8, ok ? d.w + (long long)k * d.N + n : d.w,
            ok ? 16 : 0);
  }
}

// The A rows [m0, m0 + bm) of k-step `ks` into ring slot `slot`.
__device__ __forceinline__ void qt_up_fetch_a(const QtUpGemm& d, int m0, int ks, int slot,
                                              __nv_bfloat16* A) {
  for (int idx = threadIdx.x; idx < d.bm * 8; idx += PK_NT) {
    const int r = idx >> 3, ch = idx & 7, m = m0 + r, k = ks * UP_BK + ch * 8;
    bool ok = m < d.M && k < d.K;
    const __nv_bfloat16* src = d.a;
    if (ok) {  // lda % 8 == 0: a chunk never straddles two taps
      const int tap = k / d.lda, shift = d.taps - 1 - tap;
      ok = m % d.seq >= shift;
      src = d.a + (long long)(m - shift) * d.lda + (k - tap * d.lda);
    }
    qt_cp16(A + slot * UP_A_ST + r * UP_LD + ch * 8, ok ? src : d.a, ok ? 16 : 0);
  }
}

// The first weight tiles (up to UP_STAGES - 1) of this block's first item
// of phase d into slots 0.., as one cp.async group; returns how many.
__device__ int qt_up_prefetch(const QtUpGemm& d, unsigned char* smem) {
  if ((int)blockIdx.x >= qt_up_items(d)) return 0;
  const QtUpItem r = qt_up_item(d, blockIdx.x);
  const int pre = min(UP_STAGES - 1, r.nst);
  __nv_bfloat16* W = reinterpret_cast<__nv_bfloat16*>(smem) + UP_STAGES * UP_A_ST;
  for (int s = 0; s < pre; ++s) qt_up_fetch_w(d, r.n0, r.k0 + s, s, W);
  qt_cp_commit();
  return pre;
}

__device__ __forceinline__ float qt_gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// The epilogue of output pair (m, n), (m, n + 1).
__device__ __forceinline__ void qt_up_store(const QtUpGemm& d, int m, int n, float v0,
                                            float v1) {
  const long long at = (long long)m * d.N + n;
  v0 += d.bias[n], v1 += d.bias[n + 1];
  if (d.epi == UP_E_GELU) {
    v0 = qt_gelu(v0), v1 = qt_gelu(v1);
  } else if (d.epi == UP_E_RES) {
    v0 = __ldcg(d.res + at) + d.gamma[n] * v0;
    v1 = __ldcg(d.res + at + 1) + d.gamma[n + 1] * v1;
  }
  if (d.c_bf16)
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(d.c) + at) =
        __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(d.c) + at) = make_float2(v0, v1);
}

// One GEMM phase with MI m16 blocks a warp (bm = 64 MI); `pre` weight
// tiles of the block's first item are already requested. Before the
// epilogue of its last item, the block requests the first tiles of
// phase `dn` (when `next`); returns how many.
template <int MI>
__device__ int qt_up_gemm_phase(const QtUpArgs& p, const QtUpGemm& d, int pre,
                                const QtUpGemm& dn, bool next, unsigned char* smem) {
  __shared__ int last_in;
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* W = A + UP_STAGES * UP_A_ST;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 16 * MI, wn = (warp & 3) * 16;
  const int gr = lane >> 2, tc = (lane & 3) * 2;
  const int items = qt_up_items(d);
  int pre_next = 0;
  bool requested = false;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const QtUpItem r = qt_up_item(d, it);
    float acc[MI][2][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < UP_STAGES - 1; ++s) {
      if (s < r.nst) {
        if (s >= pre) qt_up_fetch_w(d, r.n0, r.k0 + s, s, W);
        qt_up_fetch_a(d, r.m0, r.k0 + s, s, A);
      }
      qt_cp_commit();
    }
    pre = 0;
    for (int i = 0; i < r.nst; ++i) {
      qt_cp_wait<UP_STAGES - 2>();
      __syncthreads();  // step i landed; every warp is done with step i - 1's slot
      const int j = i + UP_STAGES - 1;
      if (j < r.nst) {
        qt_up_fetch_w(d, r.n0, r.k0 + j, j % UP_STAGES, W);
        qt_up_fetch_a(d, r.m0, r.k0 + j, j % UP_STAGES, A);
      }
      qt_cp_commit();
      const __nv_bfloat16* as = A + (i % UP_STAGES) * UP_A_ST;
      const __nv_bfloat16* ws = W + (i % UP_STAGES) * UP_W_ST;
#pragma unroll
      for (int k16 = 0; k16 < UP_BK / 16; ++k16) {
        uint32_t bq[4];
        qt_ldsm_b(bq, ws + k16 * 16 * UP_LD + wn, UP_LD);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          if (r.m0 + wm + mi * 16 >= d.M) continue;  // warp-uniform: rows past M
          uint32_t af[4];
          qt_ldsm_a(af, as + (wm + mi * 16) * UP_LD + k16 * 16, UP_LD);
          qt_mma(acc[mi][0], af, bq[0], bq[1]);
          qt_mma(acc[mi][1], af, bq[2], bq[3]);
        }
      }
    }
    qt_cp_wait<0>();
    __syncthreads();  // the ring is free
    if (it + (int)gridDim.x >= items && next) {
      pre_next = qt_up_prefetch(dn, smem);
      requested = true;
    }

    if (d.ks > 1) {  // partial sums; the tile's last arrival adds them up
      float* part = p.part + (long long)r.split * d.M * d.N;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int n = r.n0 + wn + nj * 8 + tc;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int m = r.m0 + wm + mi * 16 + gr + hf * 8;
            if (m < d.M && n < d.N)
              __stcg(reinterpret_cast<float2*>(part + (long long)m * d.N + n),
                     make_float2(acc[mi][nj][2 * hf], acc[mi][nj][2 * hf + 1]));
          }
        }
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        last_in = atomicAdd(p.cnt + r.tile, 1) == d.ks - 1;
        if (last_in) p.cnt[r.tile] = 0;  // no more arrivals at this tile in this launch
      }
      __syncthreads();
      if (!last_in) continue;
      __threadfence();
      // sum = 0 + part[0] + ... + part[ks - 1]; a thread's loads of one
      // partial are independent, so each partial costs one L2 round trip
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[mi][e >> 2][e & 3] = 0.f;
      for (int q = 0; q < d.ks; ++q) {
        const float* pq = p.part + (long long)q * d.M * d.N;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            const int n = r.n0 + wn + nj * 8 + tc;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int m = r.m0 + wm + mi * 16 + gr + hf * 8;
              if (m >= d.M || n >= d.N) continue;
              const float2 v = __ldcg(reinterpret_cast<const float2*>(pq + (long long)m * d.N + n));
              acc[mi][nj][2 * hf] += v.x, acc[mi][nj][2 * hf + 1] += v.y;
            }
          }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = r.n0 + wn + nj * 8 + tc;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = r.m0 + wm + mi * 16 + gr + hf * 8;
          if (m < d.M && n < d.N)
            qt_up_store(d, m, n, acc[mi][nj][2 * hf], acc[mi][nj][2 * hf + 1]);
        }
      }
  }
  if (!requested && next) pre_next = qt_up_prefetch(dn, smem);  // no item here
  return pre_next;
}

__device__ int qt_up_gemm(const QtUpArgs& p, int gi, int pre, int gn, unsigned char* smem) {
  const QtUpGemm d = qt_up_gemm_desc(p, gi);
  const bool next = gn >= 0;
  const QtUpGemm dn = qt_up_gemm_desc(p, next ? gn : gi);
  return d.bm == 128 ? qt_up_gemm_phase<2>(p, d, pre, dn, next, smem)
                     : qt_up_gemm_phase<1>(p, d, pre, dn, next, smem);
}

// g = bf16(LayerNorm(dw_b + sum_j dw[j] z[m - 6 + j])): one warp a row,
// rows dealt across the blocks first; C <= 1024, C % 8 == 0.
__device__ void qt_up_dwln_phase(const QtUpArgs& p) {
  const int M = 2 * p.B * p.T, S = 2 * p.T, C = p.C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = blockIdx.x + gridDim.x * warp; r < M; r += gridDim.x * PK_WARPS) {
    const int pos = r % S;
    float4 h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 4 * lane + 128 * i;
      h[i] = c < C ? __ldg(reinterpret_cast<const float4*>(p.dw_b + c)) : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < 7; ++j) {  // unrolled: the taps' loads in flight together
      const int shift = 6 - j;
      if (pos < shift) continue;
      const float* zr = p.z + (long long)(r - shift) * C;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 4 * lane + 128 * i;
        if (c >= C) continue;
        const float4 v = __ldcg(reinterpret_cast<const float4*>(zr + c));
        const float4 w = __ldg(reinterpret_cast<const float4*>(p.dw + j * C + c));
        h[i].x = fmaf(w.x, v.x, h[i].x), h[i].y = fmaf(w.y, v.y, h[i].y);
        h[i].z = fmaf(w.z, v.z, h[i].z), h[i].w = fmaf(w.w, v.w, h[i].w);
      }
    }
    float s1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (4 * lane + 128 * i < C) s1 += (h[i].x + h[i].y) + (h[i].z + h[i].w);
    const float mu = qt_warp_sum(s1) / (float)C;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (4 * lane + 128 * i < C) {
        const float a = h[i].x - mu, b = h[i].y - mu, c = h[i].z - mu, e = h[i].w - mu;
        s2 += (a * a + b * b) + (c * c + e * e);
      }
    const float rs = rsqrtf(qt_warp_sum(s2) / (float)C + 1e-6f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 4 * lane + 128 * i;
      if (c >= C) continue;
      const float4 w = __ldg(reinterpret_cast<const float4*>(p.ln_w + c));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.ln_b + c));
      __nv_bfloat162 lo = __floats2bfloat162_rn((h[i].x - mu) * rs * w.x + b.x,
                                                (h[i].y - mu) * rs * w.y + b.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn((h[i].z - mu) * rs * w.z + b.z,
                                                (h[i].w - mu) * rs * w.w + b.w);
      uint2 v;
      v.x = *reinterpret_cast<uint32_t*>(&lo);
      v.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p.g + (long long)r * C + c) = v;
    }
  }
}

// xb = bf16(x) for fp32 x, four values a thread at a time.
__device__ void qt_up_round_x(const QtUpArgs& p) {
  const long long n4 = (long long)p.B * p.T * p.C / 4;
  for (long long i = (long long)blockIdx.x * PK_NT + threadIdx.x; i < n4;
       i += (long long)gridDim.x * PK_NT) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p.x) + i);
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    reinterpret_cast<uint2*>(p.xb)[i] = u;
  }
}

// With p.stamps set (a measurement, off on every model path), block 0
// records the time at the start and after each barrier, and one more
// barrier ends the call, so stamps[i + 1] - stamps[i] is phase i's time.
__device__ __forceinline__ void qt_up_stamp(const QtUpArgs& p, int& i) {
  if (p.stamps && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[i] = t;
  }
  ++i;
}

__global__ void __launch_bounds__(PK_NT, 1) qt_up_persistent_kernel(const QtUpArgs p) {
  extern __shared__ __align__(128) unsigned char qt_up_smem[];
  const bool fold = p.ic_w != nullptr;
  int st = 0;
  qt_up_stamp(p, st);
  int pre = qt_up_prefetch(qt_up_gemm_desc(p, 0), qt_up_smem);
  if (p.xb) {
    qt_up_round_x(p);
    qt_grid_sync();
    qt_up_stamp(p, st);
  }
  pre = qt_up_gemm(p, 0, pre, 1, qt_up_smem);  // pw1's first tiles land under dwln
  qt_grid_sync();
  qt_up_stamp(p, st);
  qt_up_dwln_phase(p);
  qt_grid_sync();
  qt_up_stamp(p, st);
  pre = qt_up_gemm(p, 1, pre, 2, qt_up_smem);
  qt_grid_sync();
  qt_up_stamp(p, st);
  pre = qt_up_gemm(p, 2, pre, fold ? 3 : -1, qt_up_smem);
  if (fold) {
    qt_grid_sync();
    qt_up_stamp(p, st);
    qt_up_gemm(p, 3, pre, -1, qt_up_smem);
  }
  if (p.stamps) {
    qt_grid_sync();
    qt_up_stamp(p, st);
  }
}

}  // namespace

extern "C" int qt_up_persistent_grid(int smem, int* blocks) {
  return qt_persistent_grid(qt_up_persistent_kernel, smem, blocks);
}

// One call of the bf16 stage: a cooperative launch of `grid` blocks with
// `smem` bytes of dynamic shared memory (the plan of
// ops/cuda/upsample_kernel.py::stage_plan).
extern "C" int qt_up_persistent(const QtUpArgs* args, int grid, int smem, void* stream) {
  if (args->B <= 0 || args->T <= 0) return 0;
  QtPlan plan{};
  plan.grid = grid;
  plan.smem = smem;
  return qt_persistent_launch(qt_up_persistent_kernel, args, plan, stream);
}
