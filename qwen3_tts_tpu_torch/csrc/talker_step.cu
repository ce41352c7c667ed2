// K1: one talker decode step over all layers, W8A8 (rowwise int8 weights,
// per-token symmetric int8 activations, exact int32 dots, output-side
// dequant), with GQA attention over the ring KV cache and the codec head.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/talker_megakernel.py::
// _talker_kernel (called through talker_step_kernel).
//
// What bounds it on the H100: every step reads all int8 layer weights once
// (443.6 MB at 0.6B) plus the valid KV rows, for ~2 operations per weight
// byte: device memory bandwidth (3.35 TB/s), about 0.14 ms per step.
//
// Design: like the TPU kernel, which walks a sequential grid over the
// layers with the hidden state in VMEM, the whole step is one launch: a
// persistent cooperative grid, one block per SM (w8a8.cuh), that runs per
// layer five phases with a grid barrier after each (140 at 28 layers):
// qkv GEMV (RMSNorm prologue) | attention (w8a8.cuh: a block per kv head
// and cache chunk) | o GEMV + residual | gate/up GEMV (RMSNorm prologue) |
// down GEMV (SiLU prologue) + residual; then the codec head with the final
// norm, where block 0 also writes the final-normed hidden state and
// pos[slot]. The embed row enters as the first qkv phase's input, read by
// every block into shared memory. Each block streams its rows of the next
// GEMV phases into shared memory with bulk copies while it computes (the
// weights do not depend on the activations), so after a barrier its weights
// are already there or on their way. The hidden state stays in an fp32
// scratch row in L2. Each layer writes its new K/V rows into ring slot
// position % C in place: that slot stays masked while pos[slot] holds its
// old position, and pos[slot] is written only after the last layer has
// attended, so no layer sees the current token twice.

#include "w8a8.cuh"

struct QtTalkerArgs {
  QtLayers lay;
  QtPlan plan;
  const float* fin_ln;  // [1, hc]
  const int8_t* ch_q;   // [V, hc]
  const float *ch_s, *ch_m;  // [1, V]
  const void* embed;  // [hc] model dtype
  int embed_bf16;
  void *k2, *v2;      // [nl, C, nkv * hd] model dtype
  int kv_bf16;
  long long* pos;     // [C]
  const long long *position, *window_start;  // device scalars
  const float *cos, *sin;                    // [hd] for `position`
  void* h_out;        // [hc] model dtype: final-normed hidden state
  float* logits;      // [V]
  float* part;        // [nq, nch, hd + 2] attention partials
  int* cnt;           // [nkv] zeroed counters
  int vocab, C;
};

namespace {

// The step's GEMV phases in order: 4 per layer (qkv, o, gate/up, down), then
// the codec head.
struct QtTalkerSched {
  const QtTalkerArgs* a;
  const float* x0;  // the embed row in shared memory
  int n_gemv;

  __device__ QtGemv gemv(int g) const {
    const QtLayers& w = a->lay;
    if (g < 4 * w.nl) return qt_layer_gemv(w, g / 4, g % 4, x0);
    QtGemv d{};
    d.src = w.h; d.mode = QT_VEC_RMS; d.ln = a->fin_ln; d.eps = w.eps; d.K = w.hc;
    d.O = a->vocab; d.q = a->ch_q; d.s = a->ch_s; d.m = a->ch_m; d.dst = a->logits;
    d.x_out = a->h_out; d.x_out_bf16 = a->embed_bf16;
    return d;
  }
};

__global__ void __launch_bounds__(PK_NT, 1)
    qt_talker_step_kernel(const __grid_constant__ QtTalkerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float red[32];
  const QtLayers& w = a.lay;
  float* xf = reinterpret_cast<float*>(smem + a.plan.xf);
  float* lnf = reinterpret_cast<float*>(smem + a.plan.lnf);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + a.plan.xq);
  float* x0 = reinterpret_cast<float*>(smem + a.plan.xrow);
  float* att = reinterpret_cast<float*>(smem + a.plan.att);
  const QtTalkerSched sch{&a, x0, 4 * w.nl + 1};
  QtPipe p = qt_pipe_start(sch, smem, bar, a.plan);

  for (int i = threadIdx.x; i < w.hc; i += blockDim.x) x0[i] = qt_ld(a.embed, i, a.embed_bf16);
  __syncthreads();
  qt_start_row(w, x0);
  const long long position = *a.position;
  const long long kv_layer = (long long)a.C * w.nkv * w.hd * (a.kv_bf16 ? 2 : 4);  // bytes
  qt_stage_rope(att, a.cos, a.sin, w.hd);
  QtAtt at{};
  at.kv_bf16 = a.kv_bf16; at.masked = 1; at.pos = a.pos;
  at.ws = *a.window_start; at.n = a.C; at.slot = position % a.C;
  at.qkv = w.qkv; at.nq = w.nq; at.nkv = w.nkv; at.hd = w.hd; at.eps = w.eps;
  at.scale = 1.f / sqrtf((float)w.hd); at.nch = a.plan.nch; at.S = a.plan.S;
  at.part = a.part; at.cnt = a.cnt; at.out = w.attn;

  // one flat loop over the step's phases (per layer: qkv, attention, o,
  // gate/up, down; then the codec head), so that the kernel holds one copy
  // of each phase's code and stays in the SM's instruction cache
  const int n_ph = 5 * w.nl + 1;
  int g = 0;
#pragma unroll 1
  for (int ph = 0; ph < n_ph; ++ph) {
    if (ph % 5 == 1 && ph < 5 * w.nl) {
      const int l = ph / 5;
      at.q_ln = w.q_ln + (long long)l * w.hd;
      at.k_ln = w.k_ln + (long long)l * w.hd;
      at.kc = (char*)a.k2 + l * kv_layer;
      at.vc = (char*)a.v2 + l * kv_layer;
      qt_attention_phase(at, att);
    } else {
      qt_gemv_phase(sch, p, sch.gemv(g++), xf, lnf, xq, red);
    }
    if (ph + 1 < n_ph) qt_grid_sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.pos[position % a.C] = position;
}

}  // namespace

// Grid (one block per SM) for `smem` bytes of dynamic shared memory; sets
// the kernel's shared-memory limit on the current device.
extern "C" int qt_talker_grid(int smem, int* blocks) {
  return qt_persistent_grid(qt_talker_step_kernel, smem, blocks);
}

extern "C" int qt_talker_step(const QtTalkerArgs* a, void* stream) {
  return qt_persistent_launch(qt_talker_step_kernel, a, a->plan, stream);
}
