// The GEMV of K3 (quant_matmul.cu) and K7 (packed_matmul.cu) for M <= M0
// rows: y = x @ (s * q + b)^T, q the integer weights of `BITS` bits in
// MLX's little-endian 32-value chunks of BITS words (K3: its uint8 rows,
// BITS = 8; K7: 2, 3, 4, 6 or 8 bits), s and b fp32 per output and group
// of gs (32, 64 or 128) columns of K (b null: zero).
//
// What bounds it on the H100. Its bytes (the weights once at 3.35 TB/s)
// are 0.3-2.1 us at the 0.6B shapes; a launch that reads nothing and writes
// its output takes several us by itself (chip_smoke.py's floor lines), and
// on the CUDA cores each weight costs ~5-7 issue slots (its unpack, dequant
// and product; integer ones at half rate), so at these sizes the call is
// bound by its latency chain and its instructions more than by its bytes
// (scripts/torch_qmm_gemv_sweep.py, scripts/torch_qmm_gemv_ablation.py,
// PERF.md). The design keeps every load of a call in flight at once and
// the instructions a weight few.
//
// The plan (ops/cuda/qmm_gemv.py::plan, mirrored here; its K split L comes
// in as `ks`):
// - A thread owns R consecutive outputs (2 where a block holds <= 2 rows of
//   x, 4 above, so each x value read from shared memory serves R outputs)
//   and the 32-value chunks j, j + L, j + 2L, ... of their rows: L threads
//   share a group of R outputs, and a block of 256 threads holds 256 / L
//   groups. The plan makes L the row's chunks (a power of two, at most
//   256), so each thread takes one chunk a row and all of a call's loads
//   go out together; with L > 32 a group spans L / 32 warps: the K of its
//   outputs is split across warps. Adjacent threads take adjacent chunks,
//   so a load instruction reads consecutive words of a row across the
//   group (16-byte loads at 4 and 8 bits, load_chunk).
// - A thread first issues the loads of its chunk of its R outputs with
//   their scales and biases (one of each a group), and only then the block
//   stages its rows of x, so the two latencies overlap.
// - x: the block's rows (at most 8; more rows go to further blocks along
//   grid.y, each reading the weights again) are staged once in shared
//   memory (dynamic: 8 x 3072 bf16 is 48 KB, fp32 96 KB) and read as
//   16-byte vectors, each serving R outputs. One row is staged as fp32
//   (bf16 x converted once a block; its product then needs no convert),
//   more rows in x's dtype (half the shared-memory reads). A chunk's 16-byte
//   piece p sits at slot p ^ qg_swz(c) of chunk c, so the 8 threads of a
//   phase, reading piece p of 8 consecutive chunks, hit 8 distinct bank
//   groups.
// - Arithmetic (the Pallas kernels' order, and the plain version's): q to
//   fp32 exactly by one byte permute into 2^23 + q less 2^23 (4 bits: the
//   word split into its low and high nibbles once), dequantized as
//   w = s * q + b (one fmaf), then x * w accumulated in fp32, value by
//   value, per output and row. A group's L partial sums are added by the
//   butterfly over min(L, 32) lanes (offsets L/2 or 16 down to 1; at
//   L >= 32 in its halving form, QgHalve), then, where L > 32, the warps'
//   sums in shared memory in warp order. So a result differs from the
//   plain version only in the order of fp32 sums, no atomics are used, and
//   two calls give the same bits.

#pragma once

#include "gemm.cuh"
#include "mma.cuh"
#include "qmm_tile.cuh"

namespace {

constexpr int QG_NT = 256;      // threads a block
constexpr int QG_MAX_ROWS = 8;  // rows of x a block

// Outputs a thread owns at a block of MT rows.
__host__ __device__ constexpr int qg_outputs(int mt) { return mt > 2 ? 4 : 2; }

// x in shared memory as fp32 (one row, or fp32 x) or as bf16.
__host__ __device__ constexpr bool qg_f32(int mt, bool xb) { return !xb || mt == 1; }

// The slot of chunk c's 16-byte piece p is p ^ qg_swz(c): an fp32 chunk is
// 8 pieces (one 128-byte bank row), a bf16 chunk 4 (two chunks a row).
template <bool F32>
__device__ __forceinline__ int qg_swz(int c) {
  return F32 ? c & 7 : (c >> 1) & 3;
}

// q as an fp32 (exact), value v of a 32-value chunk: one byte permute into
// 0x4b0000qq (2^23 + q) at 8 bits, and at 4 bits after splitting each word
// into its low and high nibbles once (the compiler shares the split
// across a word's 8 values); the generic shifts (qt_unpack_q) at 2, 3, 6.
template <int BITS>
__device__ __forceinline__ float qg_q(const uint32_t* words, int v) {
  uint32_t u;
  if constexpr (BITS == 8) {
    u = __byte_perm(words[v >> 2], 0x4b000000u, 0x7540 + (v & 3));
  } else if constexpr (BITS == 4) {
    const uint32_t w = words[v >> 3], half = v & 1 ? (w >> 4) & 0x0f0f0f0fu : w & 0x0f0f0f0fu;
    u = __byte_perm(half, 0x4b000000u, 0x7540 + ((v >> 1) & 3));
  } else {
    u = 0x4b000000u | qt_unpack_q<BITS>(words, v);
  }
  return __uint_as_float(u) - 8388608.f;
}

// Chunk c of outputs o0 .. o0 + R - 1 (words, scale, bias); zeros past N
// or past the row's C chunks.
template <int BITS, int R>
__device__ __forceinline__ void qg_fetch(const QtQmmArgs& a, int o0, int c, int C, int G,
                                         uint32_t (&wv)[R][BITS], float (&sv)[R],
                                         float (&bv)[R]) {
  const int g = c * 32 / a.gs;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int o = o0 + i;
    if (o < a.N && c < C) {
      load_chunk<BITS>(reinterpret_cast<const uint32_t*>(a.w) + ((long long)o * C + c) * BITS,
                       wv[i]);
      sv[i] = a.s[(long long)o * G + g];
      bv[i] = a.b ? a.b[(long long)o * G + g] : 0.f;
    } else {
#pragma unroll
      for (int k = 0; k < BITS; ++k) wv[i][k] = 0u;
      sv[i] = 0.f, bv[i] = 0.f;
    }
  }
}

// The sum of each of V values (V a power of two <= 32) over a warp's 32
// lanes by halving: at offset D a lane keeps half of its values and adds
// its partner's copies of them, so the warp makes V - 1 + log2(32 / V)
// shuffles instead of 5 V. Each value's partial sums pair up as in the
// plain butterfly (lane l with l ^ D at each D), so the bits are the plain
// butterfly's. Afterwards v[0] of lane l is the sum of value
// qg_halve_slot<V>(l).
template <int V, int D>
struct QgHalve {
  static __device__ __forceinline__ void run(float* v, int lane) {
    if constexpr (D > 0) {
      if constexpr (V > 1) {
        const bool up = lane & D;
#pragma unroll
        for (int k = 0; k < V / 2; ++k) {
          const float send = up ? v[k] : v[k + V / 2];
          const float keep = up ? v[k + V / 2] : v[k];
          v[k] = keep + __shfl_xor_sync(0xffffffffu, send, D);
        }
        QgHalve<V / 2, D / 2>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], D);
        QgHalve<1, D / 2>::run(v, lane);
      }
    }
  }
};

template <int V>
__device__ __forceinline__ int qg_halve_slot(int lane) {
  int k = 0;
#pragma unroll
  for (int d = 16, n = V; d > 0 && n > 1; d >>= 1, n >>= 1)
    if (lane & d) k += n / 2;
  return k;
}

// Bytes of x's staged rows (the kernel's MT rows, at most M) and of the
// warps' partial sums behind them.
__host__ __device__ constexpr long long qg_smem_bytes(int M, int K, int mt, bool xb) {
  return (long long)(M < mt ? M : mt) * K * (qg_f32(mt, xb) ? 4 : 2) +
         QG_NT / 32 * qg_outputs(mt) * mt * 4;
}

template <int BITS, int MT, bool XB>
__global__ void __launch_bounds__(QG_NT, 2) qt_qmm_gemv_kernel(const QtQmmArgs a) {
  constexpr int R = qg_outputs(MT);
  constexpr bool F32 = qg_f32(MT, XB);
  constexpr int PPC = F32 ? 8 : 4, VPP = F32 ? 4 : 8;  // 16-byte pieces a chunk, values a piece
  extern __shared__ __align__(16) unsigned char qg_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.ks, lg = __ffs(L) - 1;  // L: a power of two, 1 .. 256
  const int grp = tid >> lg, j = tid & (L - 1), groups = QG_NT >> lg;
  const int o0 = (blockIdx.x * groups + grp) * R;
  const int m0 = blockIdx.y * MT, mt = min(MT, a.M - m0);
  const int C = a.K >> 5, G = a.K / a.gs, row_pieces = C * PPC;
  float* part = reinterpret_cast<float*>(
      qg_smem + (size_t)min(MT, a.M) * a.K * (F32 ? 4 : 2));

  // the first chunk's loads go out before x is staged
  uint32_t wv[R][BITS];
  float sv[R], bv[R];
  qg_fetch<BITS, R>(a, o0, j, C, G, wv, sv, bv);

  uint4* xs = reinterpret_cast<uint4*>(qg_smem);
  if constexpr (F32 && XB) {  // one bf16 row as fp32: a 16-byte piece of 8 values, two pieces
    const uint4* xg = reinterpret_cast<const uint4*>(a.x) + (long long)m0 * a.K / 8;
    for (int idx = tid; idx < mt * C * 4; idx += QG_NT) {
      const int r = idx / (C * 4), rem = idx - r * C * 4, c = rem >> 2, p = (rem & 3) * 2;
      const uint4 h = xg[idx];
      uint4* d = xs + r * row_pieces + c * 8;
      d[p ^ qg_swz<true>(c)] = make_uint4(h.x << 16, h.x & 0xffff0000u, h.y << 16,
                                          h.y & 0xffff0000u);
      d[(p + 1) ^ qg_swz<true>(c)] = make_uint4(h.z << 16, h.z & 0xffff0000u, h.w << 16,
                                                h.w & 0xffff0000u);
    }
  } else {  // x as it is, by cp.async
    const char* xg = reinterpret_cast<const char*>(a.x) + (long long)m0 * a.K * (XB ? 2 : 4);
    for (int idx = tid; idx < mt * row_pieces; idx += QG_NT) {
      const int r = idx / row_pieces, rem = idx - r * row_pieces, c = rem / PPC, p = rem % PPC;
      qt_cp16(xs + r * row_pieces + c * PPC + (p ^ qg_swz<F32>(c)), xg + (long long)idx * 16, 16);
    }
    qt_cp_commit();
    qt_cp_wait<0>();
  }
  __syncthreads();

  constexpr int V = R * MT;
  float v[V];  // the sums of output o0 + k / MT and row m0 + k % MT
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = 0.f;

  const int n_it = j < C ? ((C - 1 - j) >> lg) + 1 : 0;  // chunks this thread takes a row
  for (int it = 0; it < n_it; ++it) {
    const int c = j + (it << lg);
    if (it) qg_fetch<BITS, R>(a, o0, c, C, G, wv, sv, bv);
    const uint4* xc = xs + c * PPC;
    const int sw = qg_swz<F32>(c);
#pragma unroll
    for (int p = 0; p < PPC; ++p) {
      float w[R][VPP];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int e = 0; e < VPP; ++e)
          w[i][e] = fmaf(qg_q<BITS>(wv[i], p * VPP + e), sv[i], bv[i]);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        if (r < mt) {
          const uint4 x4 = xc[r * row_pieces + (p ^ sw)];
          float xv[VPP];
          if constexpr (F32) {
            xv[0] = __uint_as_float(x4.x), xv[1] = __uint_as_float(x4.y);
            xv[2] = __uint_as_float(x4.z), xv[3] = __uint_as_float(x4.w);
          } else {  // a bf16 is the high half of an fp32
            const uint32_t h[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              xv[2 * e] = __uint_as_float(h[e] << 16);
              xv[2 * e + 1] = __uint_as_float(h[e] & 0xffff0000u);
            }
          }
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int e = 0; e < VPP; ++e) v[i * MT + r] = fmaf(xv[e], w[i][e], v[i * MT + r]);
        }
      }
    }
  }

  // a group's sum: with L < 32 a butterfly of shuffles over its L lanes;
  // with L >= 32 the warp's halving butterfly, then, past 32, the warps'
  // sums in warp order
  if (L < 32) {
    for (int d = L >> 1; d > 0; d >>= 1)
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], d);
    if (j == 0)
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (k % MT < mt && o0 + k / MT < a.N)
          qt_st(a.y, (long long)(m0 + k % MT) * a.N + o0 + k / MT, v[k], a.x_bf16);
    return;
  }
  QgHalve<V, 16>::run(v, lane);
  const int k = qg_halve_slot<V>(lane);  // the value this lane now holds the warp's sum of
  const bool writer = (lane & (32 / V - 1)) == 0;
  if (L == 32) {
    if (writer && k % MT < mt && o0 + k / MT < a.N)
      qt_st(a.y, (long long)(m0 + k % MT) * a.N + o0 + k / MT, v[0], a.x_bf16);
    return;
  }
  if (writer) part[warp * V + k] = v[0];
  __syncthreads();
  const int S = L >> 5;  // warps a group
  for (int t = tid; t < groups * V; t += QG_NT) {
    const int g = t / V, kk = t % V, i = kk / MT, r = kk % MT;
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += part[(g * S + s) * V + kk];
    const int o = (blockIdx.x * groups + g) * R + i;
    if (r < mt && o < a.N) qt_st(a.y, (long long)(m0 + r) * a.N + o, sum, a.x_bf16);
  }
}

// Rows of x a block takes (the kernel's MT): the next power of two of
// min(M, 8), halved while its staged rows do not fit in `smem_max` bytes.
__host__ __device__ constexpr int qg_row_tile(int M, int K, bool xb, int smem_max) {
  int mt = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : QG_MAX_ROWS;
  while (mt > 1 && qg_smem_bytes(M, K, mt, xb) > smem_max) mt >>= 1;
  return mt;
}

template <int BITS, int MT, bool XB>
int qg_launch(const QtQmmArgs& a, int smem_max, cudaStream_t stream) {
  const long long smem = qg_smem_bytes(a.M, a.K, MT, XB);
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  static unsigned long long opted = 0;  // devices this kernel may use smem_max on
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= 64 || !(opted >> dev & 1ull))) {
    e = cudaFuncSetAttribute(qt_qmm_gemv_kernel<BITS, MT, XB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted |= 1ull << dev;
  }
  const int outs = (QG_NT / a.ks) * qg_outputs(MT);  // outputs a block
  const dim3 grid((a.N + outs - 1) / outs, (a.M + MT - 1) / MT);
  qt_qmm_gemv_kernel<BITS, MT, XB><<<grid, QG_NT, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BITS, bool XB>
int qg_launch_rows(const QtQmmArgs& a, int smem_max, cudaStream_t stream) {
  switch (qg_row_tile(a.M, a.K, XB, smem_max)) {
    case 1: return qg_launch<BITS, 1, XB>(a, smem_max, stream);
    case 2: return qg_launch<BITS, 2, XB>(a, smem_max, stream);
    case 4: return qg_launch<BITS, 4, XB>(a, smem_max, stream);
    default: return qg_launch<BITS, QG_MAX_ROWS, XB>(a, smem_max, stream);
  }
}

// One call of the GEMV (the C entries launch it for M <= m0); a.ks is the
// plan's K split L.
template <int BITS>
int qt_qmm_gemv(const QtQmmArgs& a, cudaStream_t stream) {
  if ((a.gs != 32 && a.gs != 64 && a.gs != 128) || a.K % 32 || a.K % a.gs || a.ks < 1 ||
      a.ks > QG_NT || (a.ks & (a.ks - 1)))
    return (int)cudaErrorInvalidValue;
  static int smem_max[64] = {0};  // the opt-in shared memory of a block, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int mx = dev < 64 ? smem_max[dev] : 0;
  if (!mx) {
    e = cudaDeviceGetAttribute(&mx, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) smem_max[dev] = mx;
  }
  return a.x_bf16 ? qg_launch_rows<BITS, true>(a, mx, stream)
                  : qg_launch_rows<BITS, false>(a, mx, stream);
}

}  // namespace
