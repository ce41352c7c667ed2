// Shared phases of the persistent megakernels K1 (talker_step.cu) and K2
// (cp_frame.cu): the W8A8 GEMV and the single-token attention over a small
// KV cache, as __device__ functions that every block of one cooperative
// launch runs in turn, with a grid-wide barrier between phases.
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
// The launch: one block of PK_NT threads per SM (cudaLaunchCooperativeKernel,
// grid from the occupancy query), persistent over the whole step or frame.
// Between phases, cooperative_groups' grid.sync().
//
// A GEMV phase gives block b the contiguous output rows
// [b * O / G, (b + 1) * O / G) (ops/cuda/persistent.py::row_span mirrors it):
// in the row-major [O, K] int8 tree that is one contiguous run of bytes. The
// weights never depend on activations, so a block fetches its rows for the
// phases ahead into shared memory while it computes: two buffers of
// plan.buf bytes, each filled by one cp.async.bulk (global -> shared, 1-D,
// completing on an mbarrier). The block's rows of every GEMV phase of the
// launch, cut into tiles of at most plan.buf bytes, form one sequence; tile
// i goes to buffer i % 2, and tile i + 1 is requested once the block has
// built its input row for tile i (qt_gemv_phase), so each copy has the rest
// of one phase, a barrier and the next input row to land, and none is
// queued ahead of that row's loads. After the barrier a block only reads the
// activation row (<= 24 KB, from L2), rebuilds the int8 row xq in shared
// memory (RMSNorm or SiLU(gate) * up, max |x|, quantization) and runs the
// dot: one warp per row, __dp4a on 16 bytes per lane. At M = 1 a
// tensor-core tile would waste 15 of its 16 rows, and the int8 work of a
// 0.6B talker step is ~7 us of dp4a throughput against ~130 us of weight
// bytes, so tensor cores buy nothing here.
//
// Data written inside a launch (activation rows, qkv, the KV cache, logits,
// partial sums) is read with ld.global.cg (L2, coherent across SMs), never
// through the non-coherent path; weights are read with __ldg or bulk copies.

#pragma once

#include <cooperative_groups.h>

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

// The launch's shape and dynamic shared memory, from the host
// (ops/cuda/persistent.py::make_plan): byte offsets into the dynamic shared
// memory of the two weight buffers ([0, buf) and [buf, 2 buf)), the fp32
// input row xf [kmax] and RMSNorm gain lnf [kmax], the int8 row xq [kmax],
// the fp32 token row xrow [hc] and the attention scratch (carved at the
// top of qt_attention_phase; persistent.py::att_floats sizes it);
// and the attention split.
struct QtPlan {
  int grid, smem, buf, xf, lnf, xq, xrow, att;
  int nch, S;  // chunks of the cache per kv head, slots per chunk
};

namespace {

namespace cg = cooperative_groups;

constexpr int PK_NT = 512, PK_WARPS = PK_NT / 32;

__device__ __forceinline__ void qt_grid_sync() { cg::this_grid().sync(); }

__device__ __forceinline__ float qt_ldcg(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(__ushort_as_bfloat16(
                    __ldcg(reinterpret_cast<const unsigned short*>(p) + i)))
              : __ldcg(reinterpret_cast<const float*>(p) + i);
}

// ---- bulk copies into shared memory, completing on an mbarrier ----

__device__ __forceinline__ uint32_t qt_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void qt_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(qt_smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void qt_mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One thread: copy `bytes` (a multiple of 16, both addresses 16-aligned)
// from global to shared; the barrier's phase completes when they land.
__device__ __forceinline__ void qt_bulk_load(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(qt_smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(qt_smem_addr(dst)), "l"(src), "r"(bytes), "r"(qt_smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void qt_mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(qt_smem_addr(bar)), "r"(parity) : "memory");
  }
}

// ---- the W8A8 GEMV phase ----

// How a GEMV phase builds its input row x[0:K] from `src`.
enum QtVecMode { QT_VEC_PLAIN = 0, QT_VEC_RMS = 1, QT_VEC_SILU = 2 };

struct QtGemv {
  const float* src;  // fp32 input; QT_VEC_SILU reads [2K]: gate then up
  int local;         // src lies in this block's shared memory (else ld.cg)
  int mode;
  const float* ln;   // RMSNorm gain [K] (QT_VEC_RMS)
  float eps;
  int K, O;
  const int8_t* q;   // [O, K]
  const float* s;    // [O]
  const float* m;    // [O]
  float* dst;        // [O] fp32
  int residual;      // dst[o] = dst[o] + y instead of dst[o] = y
  void* x_out;       // or null: block 0 also writes the input row x here
  int x_out_bf16;
};

// Block b's rows [lo, hi) of a phase with O rows over G blocks.
__device__ __forceinline__ void qt_span(int O, int b, int& lo, int& hi) {
  lo = (int)((long long)b * O / gridDim.x);
  hi = (int)((long long)(b + 1) * O / gridDim.x);
}

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

// The block's weight pipeline: tile i of its sequence lands in buffer i % 2;
// at most tiles i and i + 1 are in flight. n_used is kept alike by every
// thread; the fetch cursor (n_fetched tiles so far) by thread 0 only.
struct QtPipe {
  unsigned char* buf0;
  uint64_t* bar;  // [2] in shared memory
  int buf;        // bytes per buffer
  int n_used;
  int g_fetch, k_fetch, n_fetched;
};

// Thread 0: request the block's next tile of the GEMV sequence `sch`, if any.
template <class Sched>
__device__ void qt_fetch(const Sched& sch, QtPipe& p) {
  while (p.g_fetch < sch.n_gemv) {
    const QtGemv d = sch.gemv(p.g_fetch);
    int lo, hi;
    qt_span(d.O, blockIdx.x, lo, hi);
    const int T = p.buf / d.K;
    const int r0 = lo + p.k_fetch * T;
    if (r0 < hi) {
      const int rows = min(T, hi - r0), b = p.n_fetched & 1;
      qt_bulk_load(p.buf0 + (size_t)b * p.buf, d.q + (long long)r0 * d.K,
                   (uint32_t)rows * d.K, &p.bar[b]);
      ++p.k_fetch;
      ++p.n_fetched;
      return;
    }
    ++p.g_fetch;
    p.k_fetch = 0;
  }
}

template <class Sched>
__device__ QtPipe qt_pipe_start(const Sched& sch, unsigned char* smem, uint64_t* bar,
                                const QtPlan& plan) {
  QtPipe p{smem, bar, plan.buf, 0, 0, 0, 0};
  if (threadIdx.x == 0) {
    qt_mbar_init(&bar[0]);
    qt_mbar_init(&bar[1]);
    qt_mbar_fence_init();
    qt_fetch(sch, p);
  }
  __syncthreads();
  return p;
}

__device__ __forceinline__ float qt_src(const QtGemv& d, int i) {
  return d.local ? d.src[i] : __ldcg(d.src + i);
}

// Build x (RMSNorm, SiLU(gate) * up or as is) into xf, then xq; returns sx.
// Each thread loads U elements of the row (and of the RMSNorm gain, into
// lnf) before it stores any, so that their loads are in flight together.
// Block 0 writes x to d.x_out when set.
__device__ float qt_prologue(const QtGemv& d, float* xf, float* lnf, int8_t* xq, float* red) {
  constexpr int U = 4;  // elements a thread loads before it stores any
  const int K = d.K;
  const bool rms = d.mode == QT_VEC_RMS, silu = d.mode == QT_VEC_SILU;
  float ss = 0.f, ax = 0.f;
  for (int i0 = threadIdx.x; i0 < K; i0 += U * blockDim.x) {
    float a[U], b[U], g[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      a[u] = i < K ? qt_src(d, i) : 0.f;
      b[u] = i < K && silu ? qt_src(d, K + i) : 0.f;
      g[u] = i < K && rms ? __ldg(d.ln + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= K) break;
      const float v = silu ? __fmul_rn(qt_silu(a[u]), b[u]) : a[u];
      xf[i] = v;
      lnf[i] = g[u];
      ss = fmaf(v, v, ss);
      ax = fmaxf(ax, fabsf(v));
    }
  }
  if (rms) {
    const float rinv = 1.f / sqrtf(qt_block_sum(ss, red) / (float)K + d.eps);
    ax = 0.f;
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      const float x = __fmul_rn(__fmul_rn(xf[i], rinv), lnf[i]);
      xf[i] = x;
      ax = fmaxf(ax, fabsf(x));
    }
  }
  ax = qt_block_max(ax, red);
  if (d.x_out != nullptr && blockIdx.x == 0)
    for (int i = threadIdx.x; i < K; i += blockDim.x) qt_st(d.x_out, i, xf[i], d.x_out_bf16);
  const float sx = fmaxf(ax / 127.f, 1e-12f);
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    xq[i] = (int8_t)fminf(fmaxf(rintf(xf[i] / sx), -127.f), 127.f);
  __syncthreads();
  return sx;
}

// The epilogue's operands of a tile's rows, loaded ahead: lane i of warp w
// holds s, m (and dst, for a residual) of the tile's row w + PK_WARPS * i.
struct QtRowOps {
  float s, m, d;
};

__device__ __forceinline__ QtRowOps qt_row_ops(const QtGemv& g, int r0, int rows) {
  const int r = (threadIdx.x >> 5) + PK_WARPS * (threadIdx.x & 31);
  QtRowOps o{0.f, 0.f, 0.f};
  if (r < rows) {
    o.s = __ldg(g.s + r0 + r);
    o.m = __ldg(g.m + r0 + r);
    if (g.residual) o.d = __ldcg(g.dst + r0 + r);
  }
  return o;
}

// One GEMV phase for this block: its rows, tile by tile from the buffers.
// The first tile's epilogue operands are loaded before the input row is
// built, so their latency hides behind it. Before it waits for tile i, the
// block requests tile i + 1 (into the buffer tile i - 1 has left): after the
// input row is built, so that the copy does not queue ahead of the row's
// loads, and with the rest of this phase, a barrier and the next row to land.
template <class Sched>
__device__ void qt_gemv_phase(const Sched& sch, QtPipe& p, const QtGemv& d, float* xf,
                              float* lnf, int8_t* xq, float* red) {
  int lo, hi;
  qt_span(d.O, blockIdx.x, lo, hi);
  if (lo >= hi && (d.x_out == nullptr || blockIdx.x != 0)) return;
  const int K = d.K, T = p.buf / K, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  QtRowOps ops = qt_row_ops(d, lo, min(T, hi - lo));
  const float sx = qt_prologue(d, xf, lnf, xq, red);
  if (lo >= hi) return;
  const int4* xq4 = reinterpret_cast<const int4*>(xq);
  int isum = 0;  // sum(xq), exact, in every warp
  for (int c = lane; c < K / 16; c += 32) {
    const int4 a = xq4[c];
    isum = __dp4a(a.x, 0x01010101, isum);
    isum = __dp4a(a.y, 0x01010101, isum);
    isum = __dp4a(a.z, 0x01010101, isum);
    isum = __dp4a(a.w, 0x01010101, isum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) isum += __shfl_xor_sync(0xffffffffu, isum, off);
  const float sxs = __fmul_rn(sx, (float)isum);
  for (int r0 = lo; r0 < hi; r0 += T) {
    const int b = p.n_used & 1, rows = min(T, hi - r0);
    if (r0 != lo) ops = qt_row_ops(d, r0, rows);
    if (threadIdx.x == 0 && p.n_fetched < p.n_used + 2) qt_fetch(sch, p);
    qt_mbar_wait(&p.bar[b], (uint32_t)((p.n_used >> 1) & 1));
    const unsigned char* wt = p.buf0 + (size_t)b * p.buf;
    for (int r = warp, i = 0; r < rows; r += PK_WARPS, ++i) {
      const int4* row = reinterpret_cast<const int4*>(wt + (size_t)r * K);
      int acc = 0;
#pragma unroll 4
      for (int c = lane; c < K / 16; c += 32) {
        const int4 w = row[c], a = xq4[c];
        acc = __dp4a(w.x, a.x, acc);
        acc = __dp4a(w.y, a.y, acc);
        acc = __dp4a(w.z, a.z, acc);
        acc = __dp4a(w.w, a.w, acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const int o = r0 + r;
      float so, mo, dv;
      if (i < 32) {  // warp-uniform
        so = __shfl_sync(0xffffffffu, ops.s, i);
        mo = __shfl_sync(0xffffffffu, ops.m, i);
        dv = __shfl_sync(0xffffffffu, ops.d, i);
      } else {
        so = __ldg(d.s + o);
        mo = __ldg(d.m + o);
        dv = d.residual ? __ldcg(d.dst + o) : 0.f;
      }
      if (lane == 0) {
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(sx, so), (float)acc), __fmul_rn(mo, sxs));
        d.dst[o] = d.residual ? __fadd_rn(dv, y) : y;
      }
    }
    __syncthreads();  // every warp is done with buffer b
    ++p.n_used;
  }
}

// GEMV `kind` (0 qkv, 1 o, 2 gate/up, 3 down) of decoder layer l; the qkv
// GEMV of a token's first layer reads the token row `x0` (shared memory).
__device__ QtGemv qt_layer_gemv(const QtLayers& w, int l, int kind, const float* x0) {
  const long long hc = w.hc, qw = (long long)(w.nq + 2 * w.nkv) * w.hd;
  const long long aw = (long long)w.nq * w.hd, gw = 2LL * w.inter;
  QtGemv d{};
  d.eps = w.eps;
  switch (kind) {
    case 0:
      d.src = l == 0 ? x0 : w.h; d.local = l == 0; d.mode = QT_VEC_RMS; d.ln = w.in_ln + l * hc;
      d.K = (int)hc; d.O = (int)qw; d.q = w.qkv_q + l * qw * hc; d.s = w.qkv_s + l * qw;
      d.m = w.qkv_m + l * qw; d.dst = w.qkv;
      break;
    case 1:
      d.src = w.attn; d.mode = QT_VEC_PLAIN; d.K = (int)aw; d.O = (int)hc;
      d.q = w.o_q + l * hc * aw; d.s = w.o_s + l * hc; d.m = w.o_m + l * hc; d.dst = w.h;
      d.residual = 1;
      break;
    case 2:
      d.src = w.h; d.mode = QT_VEC_RMS; d.ln = w.post_ln + l * hc; d.K = (int)hc; d.O = (int)gw;
      d.q = w.gu_q + l * gw * hc; d.s = w.gu_s + l * gw; d.m = w.gu_m + l * gw; d.dst = w.gu;
      break;
    default:
      d.src = w.gu; d.mode = QT_VEC_SILU; d.K = w.inter; d.O = (int)hc;
      d.q = w.dn_q + l * hc * w.inter; d.s = w.dn_s + l * hc; d.m = w.dn_m + l * hc;
      d.dst = w.h; d.residual = 1;
      break;
  }
  return d;
}

// The token row x (fp32, shared memory) starts the residual stream: each
// block writes its rows of the o / down phases' span into w.h, the rows it
// alone adds to later.
__device__ __forceinline__ void qt_start_row(const QtLayers& w, const float* x) {
  int lo, hi;
  qt_span(w.hc, blockIdx.x, lo, hi);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) w.h[i] = x[i];
}

// ---- the attention phase ----

// One token's attention for one layer, with its K/V rows written into the
// cache. Work item (kv head j, chunk c) covers cache slots [c S, c S + S) of
// the n slots and both of j's query heads (a block per item, a warp per
// slot): q and k RMS-normed and rotated (rotate-half; a warp per head, its
// row and gain loaded together), the chunk's K/V rows staged in shared
// memory as fp32 (16-byte loads), scores, and the chunk's max, sum of
// exponentials and weighted sum of V. Chunk 0 also holds the current token
// as a column of its own, from fp32 registers, not from the rounded row it
// writes into slot `slot` (which stays masked for the talker until the
// caller writes pos[slot] after the last layer). With one chunk per head
// the block writes out = acc / sum; with more, it writes its partials and
// the block that finishes a head's last chunk (an integer counter per kv
// head, reset after use) combines them in chunk order: no float atomics,
// the same result every run.
// Talker (masked): a slot counts when pos >= 0 and pos >= window start.
// Code predictor: slots 0..n-1 all count (n = the token's index t).
// hd is a multiple of 8 and at most ATT_HD_MAX.
constexpr int ATT_HD_MAX = 256;

struct QtAtt {
  const float* qkv;   // [(nq + 2 nkv) hd]: q | k | v of this token
  const float* q_ln;  // [hd]
  const float* k_ln;
  void* kc;           // this layer's cache [C, nkv * hd]
  void* vc;
  int kv_bf16;
  int masked;
  const long long* pos;  // [C] (masked)
  long long ws;          // window start (masked)
  int n;                 // cache slots to attend
  long long slot;        // where this token's rows go
  int nq, nkv, hd;
  float eps, scale;
  int nch, S;
  float* part;  // [nq, nch, hd + 2] (nch > 1)
  int* cnt;     // [nkv] (nch > 1), zero between uses
  float* out;   // [nq * hd]
};

// The position's cos / sin [hd] into the head of the attention scratch,
// where every attention phase of the step (or of the token pass) reads them.
__device__ __forceinline__ void qt_stage_rope(float* sm, const float* cos, const float* sin,
                                              int hd) {
  for (int e = threadIdx.x; e < hd; e += blockDim.x) {
    sm[e] = __ldg(cos + e);
    sm[hd + e] = __ldg(sin + e);
  }
}

// 16 bytes of a cache row (8 bf16 or 4 fp32 values) from element `at`.
__device__ __forceinline__ int4 qt_ld16(const void* src, long long at, int bf16) {
  return __ldcg(reinterpret_cast<const int4*>(reinterpret_cast<const char*>(src) +
                                              (at << (bf16 ? 1 : 2))));
}

// Those 16 bytes as fp32 values into dst.
__device__ __forceinline__ void qt_unpack16(int4 v, int bf16, float* dst) {
  const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (bf16) {
      dst[2 * i] = __uint_as_float(w[i] << 16);
      dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      dst[i] = __uint_as_float(w[i]);
    }
  }
}

__device__ void qt_attention_phase(const QtAtt& a, float* sm) {
  const int hd = a.hd, group = a.nq / a.nkv, kvw = a.nkv * hd, S = a.S, nch = a.nch;
  const float* cs = sm;             // [hd] cos, [hd] sin (qt_stage_rope)
  const float* sn = sm + hd;
  float* qs = sm + 2 * hd;          // [group, hd] normed, rotated q
  float* ks = qs + group * hd;      // [hd] the token's k, normed and rotated
  float* vs = ks + hd;              // [hd] its v
  float* tmp = vs + hd;             // [group + 1, hd] q and k before RoPE
  float* sc = tmp + (group + 1) * hd;  // [group, S] scores, then exponentials
  float* st = sc + group * S;       // [group, 4]: max, sum, own score, own weight
  float* kst = st + 4 * group;      // [S, hd]; the combine's chunk weights
  float* vst = kst + S * hd;        // [S, hd]
  int* last = reinterpret_cast<int*>(vst + S * hd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, h2 = hd / 2;
  const int vec = a.kv_bf16 ? 8 : 4;
  for (int item = blockIdx.x; item < a.nkv * nch; item += gridDim.x) {
    const int j = item / nch, c = item % nch;
    const int s0 = c * S, ns = max(min(a.n - s0, S), 0);
    // every load of the item is in flight before its first shared-memory
    // store: the chunk's first 16 bytes of K and V per thread, the token's
    // v, then (below) each warp's q or k row with its gain
    auto slot_at = [&](int u) { return (long long)(s0 + u / hd) * kvw + j * hd + u % hd; };
    const int u0 = tid * vec;
    int4 k16 = make_int4(0, 0, 0, 0), v16 = k16;
    if (u0 < ns * hd) {
      k16 = qt_ld16(a.kc, slot_at(u0), a.kv_bf16);
      v16 = qt_ld16(a.vc, slot_at(u0), a.kv_bf16);
    }
    const float vt = tid < hd ? __ldcg(a.qkv + (long long)(a.nq + a.nkv + j) * hd + tid) : 0.f;
    for (int r = warp; r <= group; r += PK_WARPS) {  // q heads of j, then k_j
      const float* src = a.qkv + (long long)(r < group ? j * group + r : a.nq + j) * hd;
      const float* gain = r < group ? a.q_ln : a.k_ln;
      float v[ATT_HD_MAX / 32], g[ATT_HD_MAX / 32], ssq = 0.f;
#pragma unroll
      for (int u = 0; u < ATT_HD_MAX / 32; ++u) {
        const int e = lane + 32 * u;
        v[u] = e < hd ? __ldcg(src + e) : 0.f;
        g[u] = e < hd ? __ldg(gain + e) : 0.f;
        ssq = fmaf(v[u], v[u], ssq);
      }
      const float rinv = 1.f / sqrtf(qt_warp_sum(ssq) / (float)hd + a.eps);
      float* t = tmp + r * hd;
#pragma unroll
      for (int u = 0; u < ATT_HD_MAX / 32; ++u)
        if (lane + 32 * u < hd) t[lane + 32 * u] = __fmul_rn(__fmul_rn(v[u], rinv), g[u]);
      __syncwarp();
      float* dst = r < group ? qs + r * hd : ks;
      for (int e = lane; e < hd; e += 32) {
        const float rot = e < h2 ? -t[e + h2] : t[e - h2];
        dst[e] = __fadd_rn(__fmul_rn(t[e], cs[e]), __fmul_rn(rot, sn[e]));
      }
    }
    if (tid < hd) vs[tid] = vt;
    for (int e = tid + PK_NT; e < hd; e += PK_NT)
      vs[e] = __ldcg(a.qkv + (long long)(a.nq + a.nkv + j) * hd + e);
    if (u0 < ns * hd) {
      qt_unpack16(k16, a.kv_bf16, kst + u0);
      qt_unpack16(v16, a.kv_bf16, vst + u0);
    }
    for (int u = u0 + PK_NT * vec; u < ns * hd; u += PK_NT * vec) {
      qt_unpack16(qt_ld16(a.kc, slot_at(u), a.kv_bf16), a.kv_bf16, kst + u);
      qt_unpack16(qt_ld16(a.vc, slot_at(u), a.kv_bf16), a.kv_bf16, vst + u);
    }
    __syncthreads();
    if (c == 0)
      for (int e = tid; e < hd; e += PK_NT) {
        qt_st(a.kc, a.slot * kvw + j * hd + e, ks[e], a.kv_bf16);
        qt_st(a.vc, a.slot * kvw + j * hd + e, vs[e], a.kv_bf16);
      }
    for (int s = warp; s < ns; s += PK_WARPS) {
      bool valid = true;
      if (a.masked) {
        const long long ps = __ldcg(a.pos + s0 + s);
        valid = ps >= 0 && ps >= a.ws;
      }
      for (int r = 0; r < group; ++r) {
        float d = 0.f;
        for (int e = lane; e < hd; e += 32) d = fmaf(qs[r * hd + e], kst[s * hd + e], d);
        d = qt_warp_sum(d) * a.scale;
        if (lane == 0) sc[r * S + s] = valid ? d : -1e30f;
      }
    }
    if (c == 0)
      for (int r = warp; r < group; r += PK_WARPS) {
        float d = 0.f;
        for (int e = lane; e < hd; e += 32) d = fmaf(qs[r * hd + e], ks[e], d);
        d = qt_warp_sum(d) * a.scale;
        if (lane == 0) st[r * 4 + 2] = d;
      }
    __syncthreads();
    for (int r = warp; r < group; r += PK_WARPS) {
      float mx = -INFINITY;
      for (int s = lane; s < ns; s += 32) mx = fmaxf(mx, sc[r * S + s]);
      mx = qt_warp_max(mx);
      if (c == 0) mx = fmaxf(mx, st[r * 4 + 2]);
      float l = 0.f;
      for (int s = lane; s < ns; s += 32) {
        const float e = expf(sc[r * S + s] - mx);
        sc[r * S + s] = e;
        l += e;
      }
      l = qt_warp_sum(l);
      const float own = c == 0 ? expf(st[r * 4 + 2] - mx) : 0.f;
      if (lane == 0) {
        st[r * 4] = mx;
        st[r * 4 + 1] = l + own;
        st[r * 4 + 3] = own;
      }
    }
    __syncthreads();
    for (int i = tid; i < group * hd; i += PK_NT) {
      const int r = i / hd, e = i % hd, head = j * group + r;
      float acc = 0.f;
      for (int s = 0; s < ns; ++s) acc = fmaf(sc[r * S + s], vst[s * hd + e], acc);
      if (c == 0) acc = fmaf(st[r * 4 + 3], vs[e], acc);
      if (nch == 1) {
        a.out[(long long)head * hd + e] = acc / st[r * 4 + 1];
      } else {
        float* pp = a.part + ((long long)head * nch + c) * (hd + 2);
        pp[e] = acc;
        if (e == 0) {
          pp[hd] = st[r * 4];
          pp[hd + 1] = st[r * 4 + 1];
        }
      }
    }
    if (nch > 1) {
      __threadfence();
      __syncthreads();
      if (tid == 0) *last = atomicAdd(a.cnt + j, 1) == nch - 1;
      __syncthreads();
      if (*last) {  // combine j's chunks: their max and sum into shared memory first
        __threadfence();
        float* cw = kst;  // [group, nch] chunk weights, then [group] sums in st
        const float* pj = a.part + (long long)j * group * nch * (hd + 2);
        for (int i = tid; i < group * nch; i += PK_NT) {
          cw[i] = __ldcg(pj + (long long)i * (hd + 2) + hd);
          vst[i] = __ldcg(pj + (long long)i * (hd + 2) + hd + 1);
        }
        __syncthreads();
        for (int r = warp; r < group; r += PK_WARPS) {
          float mx = -INFINITY;
          for (int k = lane; k < nch; k += 32) mx = fmaxf(mx, cw[r * nch + k]);
          mx = qt_warp_max(mx);
          float l = 0.f;
          for (int k = lane; k < nch; k += 32) {
            const float wk = expf(cw[r * nch + k] - mx);
            cw[r * nch + k] = wk;
            l = fmaf(vst[r * nch + k], wk, l);
          }
          l = qt_warp_sum(l);
          if (lane == 0) st[r * 4 + 1] = l;
        }
        __syncthreads();
        for (int i = tid; i < group * hd; i += PK_NT) {
          const int r = i / hd, e = i % hd;
          const float* pp = pj + (long long)r * nch * (hd + 2) + e;
          float acc = 0.f;
#pragma unroll 8
          for (int k = 0; k < nch; ++k) acc = fmaf(__ldcg(pp + k * (hd + 2)), cw[r * nch + k], acc);
          a.out[(long long)(j * group + r) * hd + e] = acc / st[r * 4 + 1];
        }
        if (tid == 0) a.cnt[j] = 0;
      }
    }
    __syncthreads();
  }
}

// Grid for a persistent kernel: one block of PK_NT threads per SM, if the
// occupancy query says one fits with `smem` bytes of dynamic shared memory.
template <class Kernel>
int qt_persistent_grid(Kernel kernel, int smem, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  QT_TRY((int)cudaGetDevice(&dev));
  QT_TRY((int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  QT_TRY((int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return (int)cudaErrorNotSupported;
  // all the dynamic shared memory a block may opt into, so that plans of
  // other sizes launch too
  int optin = 0;
  cudaFuncAttributes fa{};
  QT_TRY((int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  QT_TRY((int)cudaFuncGetAttributes(&fa, kernel));
  const int limit = optin - (int)fa.sharedSizeBytes;
  if (smem > limit) return (int)cudaErrorInvalidValue;
  QT_TRY((int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit));
  QT_TRY((int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PK_NT, smem));
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms;
  return 0;
}

// One cooperative launch of `kernel` on `args` (a pointer to its one
// by-value struct parameter), with the plan's grid and shared memory.
template <class Kernel>
int qt_persistent_launch(Kernel kernel, const void* args, const QtPlan& plan, void* stream) {
  void* params[] = {const_cast<void*>(args)};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(plan.grid), dim3(PK_NT),
                                          params, (size_t)plan.smem, (cudaStream_t)stream);
}

}  // namespace
