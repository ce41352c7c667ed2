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
// Design: the TPU kernel walks a sequential grid over the layers with the
// hidden state in VMEM scratch. Hopper blocks run in no order, so the layer
// loop moves into this C function, which queues the step as successive
// launches on one stream (Python dispatches once): per layer qt_layer's five
// (w8a8.cuh: qkv GEMV, attention with one block per query head, o GEMV with
// the residual, gate/up GEMV, down GEMV with the residual); then the
// codec head and a last launch that writes the final-normed hidden state
// and pos[slot]. Every GEMV spreads its rows over all SMs (w8a8.cuh). The
// hidden state stays in an fp32 scratch row between launches. Each layer
// writes its new K/V rows into ring slot position % C in place: that slot
// stays masked while pos[slot] holds its old position, and pos[slot] is
// written only after the last layer has attended, so no layer sees the
// current token twice.

#include "w8a8.cuh"

struct QtTalkerArgs {
  QtLayers lay;
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
  int vocab, C;
};

namespace {

__global__ void qt_talker_finish_kernel(const float* h, const float* fin_ln, int hc, float eps,
                                        void* h_out, int out_bf16, long long* pos,
                                        const long long* position, int C) {
  __shared__ float sh[32];
  const float r = qt_block_rinv(h, hc, eps, sh);
  for (int i = threadIdx.x; i < hc; i += blockDim.x)
    qt_st(h_out, i, __fmul_rn(__fmul_rn(h[i], r), fin_ln[i]), out_bf16);
  if (threadIdx.x == 0) pos[*position % C] = *position;
}

}  // namespace

extern "C" int qt_talker_step(const QtTalkerArgs* a, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const QtLayers& w = a->lay;
  const long long kv_layer = (long long)a->C * w.nkv * w.hd * (a->kv_bf16 ? 2 : 4);  // bytes
  QT_TRY(qt_load_row(a->embed, a->embed_bf16, w.h, w.hc, st));
  for (int l = 0; l < w.nl; ++l) {
    QtAttn at{};
    at.cos = a->cos; at.sin = a->sin;
    at.kc = (char*)a->k2 + l * kv_layer; at.vc = (char*)a->v2 + l * kv_layer;
    at.kv_bf16 = a->kv_bf16; at.pos = a->pos; at.position = a->position; at.ws = a->window_start;
    at.cp_t = -1; at.C = a->C;
    QT_TRY(qt_layer(w, l, at, st));
  }
  QT_TRY(qt_gemv({w.h, QT_VEC_RMS, a->fin_ln, w.eps, w.hc, a->vocab, a->ch_q, a->ch_s, a->ch_m,
                  a->logits, 0}, st));
  qt_talker_finish_kernel<<<1, 256, 0, st>>>(w.h, a->fin_ln, w.hc, w.eps, a->h_out,
                                            a->embed_bf16, a->pos, a->position, a->C);
  return (int)cudaGetLastError();
}
