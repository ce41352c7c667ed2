// K2: a whole code-predictor frame (16 token passes x the cp layers, W8A8,
// a 16-slot KV cache, the 15 int8 lm_heads, repetition penalty,
// Gumbel-argmax sampling, the seen-set update and the next-input embedding
// rows), and K2g, its sampler as a kernel of its own.
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
// Design: the same phases as K1 (w8a8.cuh), queued from one C function: per
// token pass t = 0..15 and layer, qt_layer's five launches, the attention
// over slots 0..t of a 16-slot fp32 cache. The first two passes
// are two single-token passes at positions 0 and 1 (the talker's hidden
// state, then code 0's embedding), as the reference schedules them. After
// each pass t >= 1, group k = t - 1 runs the lm_head GEMV (final RMSNorm in
// its prologue) and one launch of the sampler kernel: it divides the logits
// of seen codes by the penalty (unconditionally, as the reference does),
// draws with Gumbel-argmax, marks the code in the seen set and writes the
// next token's input row, the dequantized row of the projected embedding
// table. That sampler kernel is K2g's kernel, so the harness tests the very
// code the frame ships.
//
// Randomness: the TPU's prng_random_bits become Philox4x32-10, keyed by a
// 64-bit seed the caller draws on the device, with counter (v / 4, row, 0,
// 0) for logit v of draw `row` (the group index in a frame); the plain
// PyTorch version reproduces the same bits. u = ((bits >> 8) + 0.5) / 2^24,
// g = -log(-log(u)), score = temp > 0 ? lg + temp * g : lg, argmax taking
// the first index on ties.

#include "w8a8.cuh"

namespace {

constexpr int SMP_NT = 256;

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
// gets the code.
__device__ int qt_gumbel_pick(const float* lg, int V, float temp, unsigned long long seed,
                              uint32_t row, const uint8_t* seen, float penalty) {
  __shared__ float best_v[32];
  __shared__ int best_i[32];
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    float l = lg[v];
    if (seen != nullptr) l = l / (seen[v] ? penalty : 1.f);
    float score = l;
    if (temp > 0.f) {
      const uint32_t u24 = qt_philox_word(seed, row, (uint32_t)v) >> 8;
      const float u = ((float)u24 + 0.5f) * (1.f / 16777216.f);
      const float g = -logf(-logf(u));
      score = __fadd_rn(l, __fmul_rn(temp, g));
    }
    if (score > bv || (score == bv && v < bi)) {
      bv = score;
      bi = v;
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

struct QtSample {
  const float* logits;
  long long ld;        // logits of block b start at logits + b * ld
  int V;
  float temp;
  const long long* seed;
  int row0;            // Philox row of block 0; block b uses row0 + b
  uint8_t* seen;       // [V] or null (no penalty)
  float penalty;
  const long long* forced;  // the code to keep instead of the draw, or null
  long long* codes;         // codes[b]
  const int8_t* emb_q;      // next input: [V, hc] rows, or null
  const float* emb_s;       // [V]
  const float* emb_m;
  int hc;
  float* x_next;            // [hc]
};

__global__ void __launch_bounds__(SMP_NT) qt_sample_kernel(const QtSample a) {
  const int b = blockIdx.x;
  int code = qt_gumbel_pick(a.logits + b * a.ld, a.V, a.temp,
                            (unsigned long long)*a.seed, (uint32_t)(a.row0 + b), a.seen,
                            a.penalty);
  if (a.forced != nullptr) code = (int)a.forced[b];
  if (threadIdx.x == 0) {
    a.codes[b] = code;
    if (a.seen != nullptr) a.seen[code] = 1;
  }
  if (a.x_next != nullptr) {
    const float s = a.emb_s[code], m = a.emb_m[code];
    const int8_t* row = a.emb_q + (long long)code * a.hc;
    for (int i = threadIdx.x; i < a.hc; i += blockDim.x)
      a.x_next[i] = __fadd_rn(__fmul_rn((float)row[i], s), m);
  }
}

}  // namespace

struct QtCpArgs {
  QtLayers lay;
  const float* fin_ln;   // [1, hc]
  const int8_t* head_q;  // [ng, V, hc]
  const float *head_s, *head_m;  // [ng, 1, V]
  const int8_t* emb_q;   // [ng, V, hc] projected into cp space
  const float *emb_s, *emb_m;
  const float *cos, *sin;  // [ng + 1, hd]
  const float* x0;         // [2, hc] fp32: talker hidden, code-0 embedding
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

// *sampler_launches counts the launches of the sampler kernel (K2g's) made
// here, one per group.
extern "C" int qt_cp_frame(const QtCpArgs* a, void* stream, int* sampler_launches) {
  const cudaStream_t st = (cudaStream_t)stream;
  const QtLayers& w = a->lay;
  const int hc = w.hc, V = a->vocab, ng = a->ng;
  const long long kv_layer = (long long)(ng + 1) * w.nkv * w.hd;
  *sampler_launches = 0;
  for (int t = 0; t <= ng; ++t) {
    if (t < 2) QT_TRY(qt_load_row(a->x0 + (long long)t * hc, 0, w.h, hc, st));
    for (int l = 0; l < w.nl; ++l) {
      QtAttn at{};
      at.cos = a->cos + (long long)t * w.hd; at.sin = a->sin + (long long)t * w.hd;
      at.kc = a->kv_k + l * kv_layer; at.vc = a->kv_v + l * kv_layer; at.kv_bf16 = 0;
      at.cp_t = t; at.C = ng + 1;
      QT_TRY(qt_layer(w, l, at, st));
    }
    if (t == 0) continue;
    const int k = t - 1;
    QT_TRY(qt_gemv({w.h, QT_VEC_RMS, a->fin_ln, w.eps, hc, V, a->head_q + (long long)k * V * hc,
                    a->head_s + (long long)k * V, a->head_m + (long long)k * V,
                    a->logits + (long long)k * V, 0}, st));

    QtSample sm{};
    sm.logits = a->logits + (long long)k * V; sm.ld = 0; sm.V = V; sm.temp = a->temp;
    sm.seed = a->seed; sm.row0 = k;
    sm.seen = a->seen ? a->seen + (long long)k * V : nullptr; sm.penalty = a->penalty;
    sm.forced = a->forced ? a->forced + k : nullptr; sm.codes = a->codes + k;
    if (t < ng) {
      sm.emb_q = a->emb_q + (long long)k * V * hc;
      sm.emb_s = a->emb_s + (long long)k * V; sm.emb_m = a->emb_m + (long long)k * V;
      sm.hc = hc; sm.x_next = w.h;
    }
    qt_sample_kernel<<<1, SMP_NT, 0, st>>>(sm);
    QT_TRY((int)cudaGetLastError());
    ++*sampler_launches;
  }
  return 0;
}

// K2g: n independent draws from one row of logits [V], rows 0..n-1 of the
// Philox stream of `seed` (no penalty).
extern "C" int qt_gumbel_sample(const float* logits, int V, float temp, const long long* seed,
                                int n, long long* codes, void* stream) {
  if (n <= 0) return 0;
  QtSample sm{};
  sm.logits = logits; sm.ld = 0; sm.V = V; sm.temp = temp; sm.seed = seed; sm.row0 = 0;
  sm.codes = codes;
  qt_sample_kernel<<<n, SMP_NT, 0, (cudaStream_t)stream>>>(sm);
  return (int)cudaGetLastError();
}
