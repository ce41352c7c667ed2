// The floor of one kernel launch: an empty kernel of `blocks` blocks of
// `threads` threads, which, given `out`, writes one float a block there (a
// launch that writes its output, as a GEMV does). A measurement entry point
// (chip_smoke.py times it the way it times the GEMV of qmm_gemv.cuh,
// inside a CUDA graph of many launches); no model path calls it.

#include <cuda_runtime.h>

namespace {

__global__ void qt_empty_kernel(float* out) {
  if (out && threadIdx.x == 0) out[blockIdx.x] = 0.f;
}

}  // namespace

extern "C" int qt_empty_launch(int blocks, int threads, float* out, void* stream) {
  qt_empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}
