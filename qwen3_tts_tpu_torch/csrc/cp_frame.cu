// K2: a whole code-predictor frame (16 token passes x the cp layers, W8A8,
// a 16-slot KV cache, the 15 int8 lm_heads, repetition penalty,
// Gumbel-argmax sampling, the seen-set update, the next-input embedding
// rows and the talker-facing embedding sum), and K2g, its sampler as a
// kernel of its own.
//
// Replace the TPU kernels qwen3_tts_tpu/ops/pallas/cp_megakernel.py::
// _cp_kernel (through predict_frame_kernel) and the body of
// gumbel_sample_kernel (the sampler's test harness).
//
// What bounds K2 on the H100: the TPU kernel keeps the 79 MB int8 layer set
// resident in 128 MB of VMEM across the 16 passes; the H100 has 50 MB of L2
// and 227 KB of shared memory per SM, so each pass reads the layer set again,
// mostly from device memory. Reading it once plus the 31.5 MB of lm_heads
// takes ~0.033 ms at 3.35 TB/s; re-reading it for every pass ~0.39 ms.
// K2g is bound by its operations (a Philox block and two logs per logit).
//
// Design: one persistent cooperative launch per frame, the phases of K1
// (w8a8.cuh) with a grid barrier after each: per token pass t = 0..15 and
// layer, qkv | attention over slots 0..t of a 16-slot fp32 cache (one block
// per kv head) | o | gate/up | down; the GEMV weights of the phases ahead
// stream into each block's shared memory by bulk copies while it computes.
// The first two passes are single-token passes at positions 0 and 1 (the
// talker's hidden state, then code 0's embedding), as the reference
// schedules them. After each pass t >= 1, group k = t - 1 runs the lm_head
// GEMV (final RMSNorm in its prologue) and, after its barrier, every block
// makes the draw itself from the 2048 logits with the same device code as
// K2g's kernel (qt_gumbel_pick): it divides the logits of seen codes by the
// penalty (unconditionally, as the reference does) and draws with
// Gumbel-argmax. Every block so knows the code and builds the next token's
// input row, the dequantized row of the projected embedding table, in its
// own shared memory, with no further barrier. Block 0 alone writes the
// codes, and at the end the seen-set marks (so that no block reads a mark
// of this frame in its own draw) and the sum of the raw embedding rows.
// 16 x 25 + 15 = 415 barriers per frame at 5 layers.
//
// Randomness: the TPU's prng_random_bits become Philox4x32-10, keyed by a
// 64-bit seed the caller draws on the device, with counter (v / 4, row, 0,
// 0) for logit v of draw `row` (the group index in a frame); the plain
// PyTorch version reproduces the same bits. u = ((bits >> 8) + 0.5) / 2^24,
// g = -log(-log(u)), score = temp > 0 ? lg + temp * g : lg, argmax taking
// the first index on ties.

#include "w8a8.cuh"

namespace {

constexpr int SMP_NT = 256, CP_MAX_GROUPS = 32;

__device__ __forceinline__ uint32_t qt_philox_word(unsigned long long seed, uint32_t row,
                                                   uint32_t v) {
  uint32_t c0 = v >> 2, c1 = row, c2 = 0u, c3 = 0u;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  const uint32_t w[4] = {c0, c1, c2, c3};
  return w[v & 3];
}

// The Gumbel pick over one row of logits, for a whole block; every thread
// gets the code. The logits may have been written earlier in the same
// launch by other blocks: they are read through L2.
__device__ int qt_gumbel_pick(const float* lg, int V, float temp, unsigned long long seed,
                              uint32_t row, const uint8_t* seen, float penalty) {
  __shared__ float best_v[32];
  __shared__ int best_i[32];
  constexpr int PER = 4;  // logits a thread loads before it draws their noise
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int v0 = threadIdx.x; v0 < V; v0 += PER * blockDim.x) {
    float l[PER];
    bool hit[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int v = v0 + u * blockDim.x;
      l[u] = v < V ? __ldcg(lg + v) : 0.f;
      hit[u] = v < V && seen != nullptr && __ldcg(seen + v);
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v >= V) break;
      if (seen != nullptr) l[u] = l[u] / (hit[u] ? penalty : 1.f);
      float score = l[u];
      if (temp > 0.f) {
        const uint32_t u24 = qt_philox_word(seed, row, (uint32_t)v) >> 8;
        const float uf = ((float)u24 + 0.5f) * (1.f / 16777216.f);
        const float g = -logf(-logf(uf));
        score = __fadd_rn(l[u], __fmul_rn(temp, g));
      }
      if (score > bv || (score == bv && v < bi)) {
        bv = score;
        bi = v;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) {
    best_v[warp] = bv;
    best_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < nw ? best_v[lane] : -INFINITY;
    bi = lane < nw ? best_i[lane] : 0x7fffffff;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) best_i[0] = bi;
  }
  __syncthreads();
  return best_i[0];
}

// K2g: block b makes draw b (Philox row b) from one row of logits.
__global__ void __launch_bounds__(SMP_NT) qt_sample_kernel(const float* logits, int V, float temp,
                                                           const long long* seed,
                                                           long long* codes) {
  const int code = qt_gumbel_pick(logits, V, temp, (unsigned long long)*seed,
                                  (uint32_t)blockIdx.x, nullptr, 1.f);
  if (threadIdx.x == 0) codes[blockIdx.x] = code;
}

}  // namespace

struct QtCpArgs {
  QtLayers lay;
  QtPlan plan;
  const float* fin_ln;   // [1, hc]
  const int8_t* head_q;  // [ng, V, hc]
  const float *head_s, *head_m;  // [ng, 1, V]
  const int8_t* emb_q;   // [ng, V, hc] projected into cp space
  const float *emb_s, *emb_m;
  const int8_t* embr_q;  // [ng, V, th] raw (talker-space) tables
  const float *embr_s, *embr_m;
  const float *cos, *sin;  // [ng + 1, hd]
  const void *x0a, *x0b;   // the first two token rows [hc]: talker hidden, code-0 embedding
  int x0a_bf16, x0b_bf16;
  const void* code0;       // [th] code-0 embedding
  int code0_bf16;
  void* esum;              // [th] out: code0 + the ng raw embedding rows, in group order
  int esum_bf16, th;
  const long long* seed;
  float temp;
  uint8_t* seen;           // [ng, V] or null
  float penalty;
  const long long* forced; // [ng] or null
  long long* codes;        // [ng]
  float* logits;           // [ng, V]
  float *kv_k, *kv_v;      // [nl, ng + 1, nkv hd] scratch
  int vocab, ng;
};

namespace {

// The frame's GEMV phases in order: pass 0's 4 per layer, then for each pass
// t >= 1 its 4 per layer and group t - 1's lm_head.
struct QtCpSched {
  const QtCpArgs* a;
  const float* x0;  // the token row in shared memory
  int n_gemv;

  __device__ QtGemv gemv(int g) const {
    const QtLayers& w = a->lay;
    const int per = 4 * w.nl;
    int j = g;
    if (g >= per) j = (g - per) % (per + 1);
    if (j < per) return qt_layer_gemv(w, j / 4, j % 4, x0);
    const int k = (g - per) / (per + 1);
    const long long V = a->vocab;
    QtGemv d{};
    d.src = w.h; d.mode = QT_VEC_RMS; d.ln = a->fin_ln; d.eps = w.eps; d.K = w.hc; d.O = a->vocab;
    d.q = a->head_q + k * V * w.hc; d.s = a->head_s + k * V; d.m = a->head_m + k * V;
    d.dst = a->logits + k * V;
    return d;
  }
};

__global__ void __launch_bounds__(PK_NT, 1)
    qt_cp_frame_kernel(const __grid_constant__ QtCpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float red[32];
  __shared__ int picked[CP_MAX_GROUPS];
  const QtLayers& w = a.lay;
  const int hc = w.hc, V = a.vocab, ng = a.ng, per = 4 * w.nl;
  float* xf = reinterpret_cast<float*>(smem + a.plan.xf);
  float* lnf = reinterpret_cast<float*>(smem + a.plan.lnf);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + a.plan.xq);
  float* x0 = reinterpret_cast<float*>(smem + a.plan.xrow);
  float* att = reinterpret_cast<float*>(smem + a.plan.att);
  const QtCpSched sch{&a, x0, per + ng * (per + 1)};
  QtPipe p = qt_pipe_start(sch, smem, bar, a.plan);
  const long long kv_layer = (long long)(ng + 1) * w.nkv * w.hd;
  QtAtt at{};
  at.qkv = w.qkv; at.nq = w.nq; at.nkv = w.nkv; at.hd = w.hd; at.eps = w.eps;
  at.scale = 1.f / sqrtf((float)w.hd); at.nch = 1; at.S = a.plan.S; at.out = w.attn;

  int g = 0;
#pragma unroll 1
  for (int t = 0; t <= ng; ++t) {
    if (t < 2) {
      for (int i = threadIdx.x; i < hc; i += blockDim.x)
        x0[i] = t == 0 ? qt_ld(a.x0a, i, a.x0a_bf16) : qt_ld(a.x0b, i, a.x0b_bf16);
      __syncthreads();
      qt_start_row(w, x0);
    }
    qt_stage_rope(att, a.cos + (long long)t * w.hd, a.sin + (long long)t * w.hd, w.hd);
    at.n = t;
    at.slot = t;
    // one flat loop over the pass's phases (per layer: qkv, attention, o,
    // gate/up, down; then the lm_head), so that the kernel holds one copy
    // of each phase's code and stays in the SM's instruction cache
    const int n_ph = 5 * w.nl + (t > 0);
#pragma unroll 1
    for (int ph = 0; ph < n_ph; ++ph) {
      if (ph % 5 == 1 && ph < 5 * w.nl) {
        const int l = ph / 5;
        at.q_ln = w.q_ln + (long long)l * w.hd;
        at.k_ln = w.k_ln + (long long)l * w.hd;
        at.kc = a.kv_k + l * kv_layer;
        at.vc = a.kv_v + l * kv_layer;
        qt_attention_phase(at, att);
      } else {
        qt_gemv_phase(sch, p, sch.gemv(g++), xf, lnf, xq, red);
      }
      qt_grid_sync();
    }
    if (t == 0) continue;
    const int k = t - 1;
    if (t == ng && blockIdx.x != 0) break;
    int code;
    if (a.forced != nullptr) {
      code = (int)a.forced[k];
    } else {
      code = qt_gumbel_pick(a.logits + (long long)k * V, V, a.temp,
                            (unsigned long long)*a.seed, (uint32_t)k,
                            a.seen ? a.seen + (long long)k * V : nullptr, a.penalty);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      a.codes[k] = code;
      picked[k] = code;
    }
    if (t < ng) {
      const long long r = (long long)k * V + code;
      const float s = __ldg(a.emb_s + r), m = __ldg(a.emb_m + r);
      const int8_t* row = a.emb_q + r * hc;
      for (int i = threadIdx.x * 16; i < hc; i += blockDim.x * 16) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(row + i));
        const int8_t* b = reinterpret_cast<const int8_t*>(&q);
#pragma unroll
        for (int u = 0; u < 16; ++u) x0[i + u] = __fadd_rn(__fmul_rn((float)b[u], s), m);
      }
      __syncthreads();
      qt_start_row(w, x0);
    }
  }
  if (blockIdx.x != 0) return;
  __syncthreads();
  if (a.seen != nullptr)
    for (int k = threadIdx.x; k < ng; k += blockDim.x) a.seen[(long long)k * V + picked[k]] = 1;
  for (int i = threadIdx.x; i < a.th; i += blockDim.x) {
    float es = 0.f;
    for (int k = 0; k < ng; ++k) {
      const long long r = (long long)k * V + picked[k];
      const float term = __fadd_rn(__fmul_rn((float)__ldg(a.embr_q + r * a.th + i),
                                             __ldg(a.embr_s + r)), __ldg(a.embr_m + r));
      es = k == 0 ? term : __fadd_rn(es, term);
    }
    qt_st(a.esum, i, __fadd_rn(qt_ld(a.code0, i, a.code0_bf16), es), a.esum_bf16);
  }
}

}  // namespace

// Grid (one block per SM) for `smem` bytes of dynamic shared memory; sets
// the kernel's shared-memory limit on the current device.
extern "C" int qt_cp_grid(int smem, int* blocks) {
  return qt_persistent_grid(qt_cp_frame_kernel, smem, blocks);
}

extern "C" int qt_cp_frame(const QtCpArgs* a, void* stream) {
  if (a->ng > CP_MAX_GROUPS) return (int)cudaErrorInvalidValue;
  return qt_persistent_launch(qt_cp_frame_kernel, a, a->plan, stream);
}

// K2g: n independent draws from one row of logits [V], rows 0..n-1 of the
// Philox stream of `seed` (no penalty).
extern "C" int qt_gumbel_sample(const float* logits, int V, float temp, const long long* seed,
                                int n, long long* codes, void* stream) {
  if (n <= 0) return 0;
  qt_sample_kernel<<<n, SMP_NT, 0, (cudaStream_t)stream>>>(logits, V, temp, seed, codes);
  return (int)cudaGetLastError();
}
