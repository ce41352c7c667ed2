// K6: the three dilated residual units of one SEANet decoder block, and on
// the last block the out_snake -> out_conv (k=7, Cout=1) -> clip tail.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/vocoder_kernels.py::
// _units_kernel (wrapper residual_units_fused, called by
// seanet_block_fused). Each unit: SnakeBeta -> 7-tap causal conv with
// dilation d (1, 3, 9) -> SnakeBeta -> 1x1 conv -> residual.
//
// What bounds it on the H100: the 7-tap convs are GEMMs of [S, 7C] x
// [7C, C]. Over the four blocks of the 0.6B vocoder (C = 768, 384, 192,
// 96; S = 32T, 160T, 640T, 1920T rows for T frames) the units do ~100
// GFLOP at T = 26 and ~420 GFLOP at T = 110, so the kernel is bound by
// tensor-core bf16 FLOPs (0.10 / 0.43 ms at 989 TFLOP/s); the bytes
// (activations once, weights once) bound it at ~0.02-0.03 ms a block.
//
// Design for bf16 weights (the pipeline's): every conv is a launch of
// qt_conv_mma_kernel, an implicit-GEMM causal conv on the tensor cores,
// whose operand arrives already activated, as bf16: SnakeBeta is applied
// where a value is made, once per element with the exact sinf, and
// rounded to bf16 there, which is where the JAX kernel casts to its
// compute dtype. A block:
//   a = bf16(snake1_0(y))                          qt_snake_bf16_kernel
//   per unit u:
//     conv1: a2 = bf16(snake2_u(b1 + sum_tap a[t - (6 - tap) d] @ W1[tap]))
//     conv2: y = y + (b2 + a2 @ W2);  a = bf16(snake1_{u+1}(y))  (or the
//            tail's out_snake after the last unit)
//   tail:  wav = clip(b + sum_tap a[t - 6 + tap] . w[tap])  qt_tail_kernel
// y stays fp32 in device memory (the last unit writes the input's dtype);
// only the MMA operands are bf16.
//
// The conv: a block owns a BM x BN output tile inside one sequence. For
// each chunk of BK input channels it copies the strip of rows [t0 - 6d,
// t0 + BM) of the operand into shared memory once (zero before the
// sequence start: the causal padding), and the seven taps are seven MMAs
// over row-shifted windows of that one strip. The strip and the chunk's
// weight tiles [7, BK, BN] arrive by 16-byte cp.async in a two-stage ring
// while the tensor cores consume the other stage. Each warp computes a
// 32 x 32 sub-tile with mma.sync m16n8k16 (bf16 operands, fp32
// accumulators, A by ldmatrix, B by ldmatrix.trans); the epilogue adds
// the bias and the residual and applies the next SnakeBeta. The tile (128
// x 128, 96 or 64, or 64 x 64) is chosen per call by the wrapper so that
// enough tiles fill the card.
//
// fp32 weights (the exact parity path) keep the shared FMA GEMM of
// gemm.cuh, two launches a unit with SnakeBeta in the prologue and the
// tail as one more 7-tap GEMM; the wrapper picks the path by the weights'
// dtype.
//
// The block's upsample before the units (plain XLA in the JAX package:
// seanet_block_fused's two products with fp32 results) is the same conv
// with 2 taps: out[t] = bias + a[t - 1] @ W_hi + a[t] @ W_lo over
// N = rate * Cout columns, where column half p of row t is output sample
// t * rate + p, so [T, rate * Cout] already is the interleaved
// [T * rate, Cout]. Its operand a = bf16(SnakeBeta(x)) comes from
// qt_snake_bf16_kernel (ops/cuda/vocoder_kernels.py::block_upsample).

#include "gemm.cuh"
#include "mma.cuh"

// One causal conv launch over B sequences of S rows:
//   v[m, n] = (res[m, n] +) bias[n] + sum_{tap, c} a[m - (taps - 1 - tap) dil, c] w[tap C + c, n]
// (a read before its sequence's start is 0); out = v when set, and
// act = bf16(v + act_binv * sin(v * act_alpha)^2) when set.
struct QtConvArgs {
  const __nv_bfloat16* a;  // [M, C], activated
  const __nv_bfloat16* w;  // [taps * C, N] row-major
  const float* bias;       // [N]
  const void* res;         // [M, N] or null (may alias out)
  int res_bf16;
  void* out;               // [M, N] or null
  int out_bf16;
  const float* act_alpha;  // [N] or null
  const float* act_binv;
  __nv_bfloat16* act;      // [M, N] or null
  int B, S, C, N, taps, dil;
};

namespace {

constexpr int QT_CV_DMAX = 9;  // the largest dilation

template <int BM, int BN, int TAPS>
struct QtConvTile {
  static constexpr int BK = TAPS == 1 ? 64 : 32;  // input channels per chunk
  static constexpr int NT = (BM / 32) * (BN / 32) * 32;
  static constexpr int LDA = BK + 8, LDW = BN + 8;  // padded rows: no bank conflicts
  static constexpr int SRMAX = BM + (TAPS - 1) * QT_CV_DMAX;  // the longest reach
  static constexpr int WST = TAPS * BK * LDW;  // elements of one weight stage
  static constexpr int SST = SRMAX * LDA;      // elements of one strip stage
  static constexpr int SMEM = (2 * WST + 2 * SST) * 2;
};

__device__ __forceinline__ float qt_snake(float v, float alpha, float binv) {
  const float s = sinf(v * alpha);
  return v + binv * (s * s);
}

template <int BM, int BN, int TAPS>
__global__ void __launch_bounds__(QtConvTile<BM, BN, TAPS>::NT)
    qt_conv_mma_kernel(const QtConvArgs g) {
  using Tl = QtConvTile<BM, BN, TAPS>;
  constexpr int BK = Tl::BK, NT = Tl::NT, LDA = Tl::LDA, LDW = Tl::LDW;
  constexpr int WN = BN / 32;  // warps across the tile's columns
  extern __shared__ __align__(16) unsigned char qt_conv_smem[];
  __nv_bfloat16* wst = reinterpret_cast<__nv_bfloat16*>(qt_conv_smem);
  __nv_bfloat16* strip = wst + 2 * Tl::WST;

  const int halo = (TAPS - 1) * g.dil;
  const int tiles = (g.S + BM - 1) / BM;
  const int b = blockIdx.y / tiles;
  const int p0 = (blockIdx.y % tiles) * BM;  // first output position in sequence b
  const int rows = min(BM, g.S - p0);
  const long long seq0 = (long long)b * g.S;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / WN) * 32, wn = (warp % WN) * 32;
  const int nchunks = (g.C + BK - 1) / BK;

  // chunk ch's weight tiles and operand strip into stage `st`, one group
  auto fetch = [&](int ch, int st) {
    constexpr int CPR = BN / 8, CPS = BK / 8;  // 16-byte chunks per weight / strip row
    const int c0 = ch * BK;
    __nv_bfloat16* wd = wst + st * Tl::WST;
    for (int idx = tid; idx < TAPS * BK * CPR; idx += NT) {
      const int col = idx % CPR, r = idx / CPR;  // r = tap * BK + kk
      const int tap = r / BK, c = c0 + r % BK, n = n0 + col * 8;
      const bool ok = c < g.C && n < g.N;
      qt_cp16(wd + r * LDW + col * 8, ok ? g.w + (long long)(tap * g.C + c) * g.N + n : g.w,
              ok ? 16 : 0);
    }
    __nv_bfloat16* sd = strip + st * Tl::SST;
    for (int idx = tid; idx < (halo + rows) * CPS; idx += NT) {
      const int r = idx / CPS, c = c0 + (idx % CPS) * 8;
      const int p = p0 - halo + r;
      const bool ok = p >= 0 && c < g.C;  // C % 8 == 0: a chunk is whole or absent
      qt_cp16(sd + r * LDA + (idx % CPS) * 8, ok ? g.a + (seq0 + p) * g.C + c : g.a,
              ok ? 16 : 0);
    }
    qt_cp_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  fetch(0, 0);
  for (int ch = 0; ch < nchunks; ++ch) {
    qt_cp_wait<0>();
    __syncthreads();  // chunk ch landed; everyone is done with the other stage
    if (ch + 1 < nchunks) fetch(ch + 1, (ch + 1) & 1);
    const __nv_bfloat16* sb = strip + (ch & 1) * Tl::SST;
    const __nv_bfloat16* wb = wst + (ch & 1) * Tl::WST;
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap) {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[2][4], bq[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          qt_ldsm_a(af[mi], sb + (wm + mi * 16 + tap * g.dil) * LDA + ks * 16, LDA);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          qt_ldsm_b(bq[nj], wb + (tap * BK + ks * 16) * LDW + wn + nj * 16, LDW);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            qt_mma(acc[mi][2 * nj], af[mi], bq[nj][0], bq[nj][1]);
            qt_mma(acc[mi][2 * nj + 1], af[mi], bq[nj][2], bq[nj][3]);
          }
      }
    }
  }

  // rows of the strip past halo + rows were never written: the MMAs read
  // them only for output rows >= rows, which are not stored
  const int gr = lane >> 2, tc = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn + nt * 8 + tc;
      if (n >= g.N) continue;  // N % 8 == 0: n + 1 < N too
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wm + mi * 16 + gr + hf * 8;
        if (r >= rows) continue;
        const long long at = (seq0 + p0 + r) * g.N + n;
        float v0 = acc[mi][nt][2 * hf] + g.bias[n];
        float v1 = acc[mi][nt][2 * hf + 1] + g.bias[n + 1];
        if (g.res) {
          v0 = qt_ld(g.res, at, g.res_bf16) + v0;
          v1 = qt_ld(g.res, at + 1, g.res_bf16) + v1;
        }
        if (g.out && g.out_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(g.out) + at) =
              __floats2bfloat162_rn(v0, v1);
        } else if (g.out) {
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(g.out) + at) = make_float2(v0, v1);
        }
        if (g.act) {
          *reinterpret_cast<__nv_bfloat162*>(g.act + at) = __floats2bfloat162_rn(
              qt_snake(v0, g.act_alpha[n], g.act_binv[n]),
              qt_snake(v1, g.act_alpha[n + 1], g.act_binv[n + 1]));
        }
      }
    }
}

template <int BM, int BN, int TAPS>
int qt_conv_launch(const QtConvArgs& g, cudaStream_t st) {
  using Tl = QtConvTile<BM, BN, TAPS>;
  const cudaError_t e = cudaFuncSetAttribute(
      qt_conv_mma_kernel<BM, BN, TAPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long mt = (long long)g.B * ((g.S + BM - 1) / BM);
  if (mt > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((g.N + BN - 1) / BN, (unsigned)mt);
  qt_conv_mma_kernel<BM, BN, TAPS><<<grid, Tl::NT, Tl::SMEM, st>>>(g);
  return (int)cudaGetLastError();
}

template <int TAPS>
int qt_conv_dispatch(const QtConvArgs& g, int bm, int bn, cudaStream_t st) {
  if (bm == 128 && bn == 128) return qt_conv_launch<128, 128, TAPS>(g, st);
  if (bm == 128 && bn == 96) return qt_conv_launch<128, 96, TAPS>(g, st);
  if (bm == 128 && bn == 64) return qt_conv_launch<128, 64, TAPS>(g, st);
  if (bm == 64 && bn == 64) return qt_conv_launch<64, 64, TAPS>(g, st);
  return (int)cudaErrorInvalidValue;
}

// out[m, c] = bf16(snake(y[m, c])): the first conv's operand.
__global__ void __launch_bounds__(256) qt_snake_bf16_kernel(
    const void* __restrict__ y, int y_bf16, const float* __restrict__ alpha,
    const float* __restrict__ binv, __nv_bfloat16* __restrict__ out, long long n, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = (int)(i % C);
  out[i] = qt_bf16(qt_snake(qt_ld(y, i, y_bf16), alpha[c], binv[c]));
}

// The tail over the activated operand a (bf16(out_snake(y))):
// wav[m] = clip(b + sum_{tap, c} a[m - 6 + tap, c] w[tap C + c], +-1) in
// fp32 sums, one warp per output row, 0 before the sequence start.
__global__ void __launch_bounds__(256) qt_tail_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, long long M, int S, int C) {
  const long long m = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= M) return;
  const int p = (int)(m % S);
  float acc = 0.f;
  for (int tap = 0; tap < 7; ++tap) {
    const int q = p - (6 - tap);
    if (q < 0) continue;
    const __nv_bfloat16* row = a + (m - p + q) * C;
    for (int c = lane; c < C; c += 32)
      acc = fmaf(__bfloat162float(row[c]), __bfloat162float(w[tap * C + c]), acc);
  }
  acc = qt_warp_sum(acc);
  if (lane == 0) out[m] = fminf(fmaxf(acc + bias[0], -1.f), 1.f);
}

}  // namespace

extern "C" int qt_units_gemm(const QtGemmArgs* g, void* stream) {
  return g->taps > 1 ? qt_gemm_launch<true, true>(g, stream)
                     : qt_gemm_launch<false, true>(g, stream);
}

// One bf16 tensor-core conv launch with tile (bm, bn): taps 7 (dil <= 9),
// 2 (the block upsample) or 1; C % 8 == 0, N % 8 == 0.
extern "C" int qt_units_conv(const QtConvArgs* g, int bm, int bn, void* stream) {
  if (g->B <= 0 || g->S <= 0) return 0;
  if (g->N % 8 || g->C % 8 || g->dil < 1 || g->dil > QT_CV_DMAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (g->taps == 7) return qt_conv_dispatch<7>(*g, bm, bn, st);
  if (g->taps == 2) return qt_conv_dispatch<2>(*g, bm, bn, st);
  if (g->taps == 1) return qt_conv_dispatch<1>(*g, bm, bn, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int qt_units_snake(const void* y, int y_bf16, const float* alpha, const float* binv,
                              void* out, long long n, int C, void* stream) {
  if (n <= 0) return 0;
  qt_snake_bf16_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      y, y_bf16, alpha, binv, reinterpret_cast<__nv_bfloat16*>(out), n, C);
  return (int)cudaGetLastError();
}

extern "C" int qt_units_tail(const void* a, const void* w, const float* bias, float* out,
                             long long M, int S, int C, void* stream) {
  if (M <= 0) return 0;
  qt_tail_kernel<<<(unsigned)((M + 7) / 8), 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(a), reinterpret_cast<const __nv_bfloat16*>(w),
      bias, out, M, S, C);
  return (int)cudaGetLastError();
}
