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
