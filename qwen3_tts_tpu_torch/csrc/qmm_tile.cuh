// The tensor-core tile of K3 (quant_matmul.cu) and K7 (packed_matmul.cu)
// for M > M0 rows: y = x @ (s * q + b)^T, q the integer weights of `BITS`
// bits (K3: uint8 bytes, which are MLX's 8-bit little-endian words; K7:
// MLX's 2/3/4/6/8-bit words), s and b fp32 per output row and group of gs
// (32, 64 or 128) columns of K (b null: zero).
//
// Arithmetic (the Pallas kernels dequantize s * q + b in fp32 and multiply
// in fp32; the dequantized weight is never rounded to bf16 here):
// - q enters the bf16 MMA as it is: every q <= 255 is exact in bf16.
// - bf16 x enters as it is; fp32 x is split into x_hi = bf16(x) and
//   x_lo = bf16(x - x_hi), two MMAs into one accumulator (~2^-17 relative).
// - Per group g the tensor core forms P[m, n] = sum_{k in g} x[m, k] q[n, k]
//   (every product exact) and X[m] = sum_{k in g} x[m, k] (an MMA against
//   a B of ones), both fp32; the fold then adds acc += s[n, g] P + b[n, g] X
//   in registers, the affine identity W8A8 uses too. The store casts to
//   x's dtype once. So a result differs from the plain version only in the
//   order of fp32 sums.
//
// The tile: QM_BM = 64 rows by QM_BN = 128 columns, 8 warps as 2 (rows) x
// 4 (columns), each 32 x 32; m16 blocks past M are skipped. A K step is 64
// columns (one group, two at gs 32, half of one at gs 128). A 4-stage ring
// holds, per step, the x rows (bf16, or fp32 read into registers and
// split), the weights' raw bytes and the step's scales and biases, all
// brought in by cp.async (x 16 bytes; the weights 16, 8 or 4 bytes, as wide
// as the row and step strides allow; s and b 4); rows, columns and values
// past M, N, K read zeros. The prologue unpacks the step's raw weights into
// one bf16 [128][64] tile (each value once a block), which ldmatrix feeds
// to mma.sync m16n8k16. Two blocks fit an SM (launch bounds, shared
// memory). The [64, 128] result is staged in the ring's shared memory and
// written four columns a thread, coalesced.
//
// Filling the card: the plan (ops/cuda/qmm_tile.py::plan) cuts K into ks
// group-aligned runs so that tiles x ks blocks fill the SMs. With ks > 1 a
// block writes its fp32 partial sums and the tile's last arriving block (an
// integer counter per tile, reset by that block, so the counters of
// persistent.counters are 0 between launches) adds the ks partials in the
// order 0..ks-1 before the store: one launch, no float atomics, the same
// bits on every call.

#pragma once

#include "gemm.cuh"
#include "mma.cuh"

struct QtQmmArgs {
  const void* x;  // [M, K] fp32 or bf16
  int x_bf16;
  const unsigned char* w;  // [N, K * bits / 8] bytes
  const float* s;          // [N, K / gs]
  const float* b;          // [N, K / gs] or null
  int gs;
  void* y;  // [M, N], x's dtype
  int M, N, K;
  int ks;       // the plan: K runs a tile
  float* part;  // [ks, M, N] partial sums (ks > 1)
  int* cnt;     // [tiles] arrival counters, 0 between launches (ks > 1)
};

namespace {

constexpr int QM_BM = 64, QM_BN = 128, QM_BK = 64, QM_STAGES = 4, QM_NT = 256, QM_LD = 72;
constexpr int QM_CLD = QM_BN + 8;  // fp32 row stride of the output tile staged for the store
constexpr uint32_t QM_ONES = 0x3f803f80u;  // two bf16 1.0

template <int BITS, bool XB>
struct QmLayout {
  static constexpr int X_BYTES = QM_BM * QM_LD * (XB ? 2 : 4);  // x rows, padded
  static constexpr int W_BYTES = QM_BN * 8 * BITS;              // raw weights of 64 values a row
  static constexpr int SB_BYTES = 4 * QM_BN * 4;                // s, b of up to 2 groups
  static constexpr int STAGE = X_BYTES + W_BYTES + SB_BYTES;
  static constexpr int SMEM = QM_STAGES * STAGE + QM_BN * QM_LD * 2;  // + the bf16 tile
  static_assert(QM_STAGES * STAGE >= QM_BM * QM_CLD * 4, "the output tile reuses the ring");
};

// `cw` (4, 8 or 16) bytes global -> shared; bytes past `src_bytes` read 0.
__device__ __forceinline__ void qm_cp(int cw, void* dst, const void* src, int src_bytes) {
  if (cw == 16)
    qt_cp16(dst, src, src_bytes);
  else if (cw == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                 ::"r"(qt_saddr(dst)), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 ::"r"(qt_saddr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// B for two adjacent n8 tiles from a [n][k] row-major bf16 tile (ldmatrix
// without .trans): b[0..1] rows [0, 8), b[2..3] rows [8, 16), k [0, 16).
__device__ __forceinline__ void qm_ldsm_bn(uint32_t (&b)[4], const __nv_bfloat16* tile, int ld) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = tile + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(qt_saddr(p)));
}

__device__ __forceinline__ uint32_t qm_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A (16 x 16 at `t`, fp32, row stride ld) as x_hi = bf16(x) and
// x_lo = bf16(x - x_hi) fragments.
__device__ __forceinline__ void qm_split_a(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* t,
                                           int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a0 (g, c), a1 (g + 8, c), a2 (g, c + 8), a3 (g + 8, c + 8)
    const float* p = t + (g + (i & 1) * 8) * ld + c + (i >> 1) * 8;
    const float2 v = *reinterpret_cast<const float2*>(p);
    const float h0 = qt_round_bf16(v.x), h1 = qt_round_bf16(v.y);
    hi[i] = qm_pack(h0, h1);
    lo[i] = qm_pack(v.x - h0, v.y - h1);
  }
}

// q (0 .. 255) as an fp32 whose low 16 bits are 0, so its high half is q
// exactly in bf16: 2^23 + q is exact in fp32, less 2^23 it is q.
__device__ __forceinline__ uint32_t qm_q_f32(uint32_t q) {
  return __float_as_uint(__uint_as_float(0x4b000000u | q) - 8388608.f);
}

// The high halves of two such fp32 as one bf16 pair (lo in the low half).
__device__ __forceinline__ uint32_t qm_pack_hi(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// the `BITS` words of one 32-value chunk, read as wide as their alignment
// allows (a chunk starts at a multiple of 4 * BITS bytes from the row start)
template <int BITS>
__device__ __forceinline__ void load_chunk(const uint32_t* __restrict__ p, uint32_t* w) {
  if constexpr (BITS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < BITS / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
    }
  } else if constexpr (BITS % 2 == 0) {
#pragma unroll
    for (int i = 0; i < BITS / 2; ++i) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = v.x, w[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BITS; ++i) w[i] = p[i];
  }
}

// Value v (0..31) of a 32-value chunk of BITS words: bits [v BITS,
// (v + 1) BITS), little-endian; a value that crosses a word boundary (3 and
// 6 bits) ORs in the high bits from the next word. v is a compile-time
// constant where the callers unroll, so are the shifts.
template <int BITS>
__device__ __forceinline__ uint32_t qt_unpack_q(const uint32_t* words, int v) {
  const int bit = v * BITS, wi = bit >> 5, off = bit & 31;
  uint32_t u = words[wi] >> off;
  if (off + BITS > 32) u |= words[wi + 1 < BITS ? wi + 1 : BITS - 1] << (32 - off);
  return u & ((1u << BITS) - 1u);
}

// The prologue: each thread unpacks 32 values (BITS words) of one weight
// row of the step's raw bytes into the bf16 tile.
template <int BITS>
__device__ __forceinline__ void qm_unpack(const unsigned char* raw, __nv_bfloat16* wb) {
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  uint32_t words[BITS];
  load_chunk<BITS>(reinterpret_cast<const uint32_t*>(raw + r * 8 * BITS + h * 4 * BITS), words);
  uint32_t out[16];
#pragma unroll
  for (int v = 0; v < 32; v += 2) {
    if constexpr (BITS == 8) {  // byte i of a word -> 0x4b0000qq by one byte permute
      const uint32_t w = words[v >> 2];
      const float f0 = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7540 + (v & 3)));
      const float f1 = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7541 + (v & 3)));
      out[v / 2] = qm_pack_hi(__float_as_uint(f0 - 8388608.f), __float_as_uint(f1 - 8388608.f));
    } else {
      out[v / 2] = qm_pack_hi(qm_q_f32(qt_unpack_q<BITS>(words, v)),
                              qm_q_f32(qt_unpack_q<BITS>(words, v + 1)));
    }
  }
  uint4* d = reinterpret_cast<uint4*>(wb + r * QM_LD + h * 32);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d[i] = make_uint4(out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3]);
}

// Step k0's x rows, raw weights and scales / biases into stage `st`.
template <int BITS, bool XB>
__device__ __forceinline__ void qm_fetch(const QtQmmArgs& a, int m0, int n0, int k0, int cw,
                                         unsigned char* st) {
  using L = QmLayout<BITS, XB>;
  const int tid = threadIdx.x;
  constexpr int ES = XB ? 2 : 4, XCH = 64 * ES / 16;  // 16-byte chunks of a row's 64 values
  for (int idx = tid; idx < QM_BM * XCH; idx += QM_NT) {
    const int r = idx / XCH, ch = idx % XCH, m = m0 + r, k = k0 + ch * 16 / ES;
    const bool ok = m < a.M && k < a.K;  // K % 32 == 0: a chunk is whole or absent
    const char* src = reinterpret_cast<const char*>(a.x) + ((long long)m * a.K + k) * ES;
    qt_cp16(st + r * QM_LD * ES + ch * 16, ok ? src : a.x, ok ? 16 : 0);
  }
  const long long row_bytes = (long long)a.K * BITS / 8;
  const int wch = 8 * BITS / cw;
  for (int idx = tid; idx < QM_BN * wch; idx += QM_NT) {
    const int r = idx / wch, c = idx % wch, n = n0 + r;
    const long long off = (long long)k0 * BITS / 8 + c * cw, left = row_bytes - off;
    const int nb = n >= a.N || left <= 0 ? 0 : left < cw ? (int)left : cw;
    qm_cp(cw, st + L::X_BYTES + r * 8 * BITS + c * cw, nb ? a.w + n * row_bytes + off : a.w, nb);
  }
  const int G = a.K / a.gs, g0 = k0 / a.gs, ng = a.gs == 32 ? 2 : 1;
  float* sb = reinterpret_cast<float*>(st + L::X_BYTES + L::W_BYTES);
  for (int idx = tid; idx < 2 * ng * QM_BN; idx += QM_NT) {
    const int n = idx & (QM_BN - 1), j = (idx >> 7) % ng, isb = (idx >> 7) / ng;
    const float* base = isb ? a.b : a.s;
    const bool ok = n0 + n < a.N && g0 + j < G && base;
    qm_cp(4, sb + (isb * 2 + j) * QM_BN + n, ok ? base + (long long)(n0 + n) * G + g0 + j : a.s,
          ok ? 4 : 0);
  }
}

// Four consecutive outputs (row m, columns n..n+3) of the [M, N] output in
// x's dtype, or only those before N.
__device__ __forceinline__ void qm_store4(const QtQmmArgs& a, int m, int n, float4 v) {
  const long long at = (long long)m * a.N + n;
  if (n + 4 <= a.N && a.N % 4 == 0) {
    if (a.x_bf16) {
      uint2 u;
      u.x = qm_pack(v.x, v.y), u.y = qm_pack(v.z, v.w);
      *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(a.y) + at) = u;
    } else {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(a.y) + at) = v;
    }
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < 4 && n + i < a.N; ++i) qt_st(a.y, at + i, e[i], a.x_bf16);
}

template <int BITS, bool XB>
__global__ void __launch_bounds__(QM_NT, 2) qt_qmm_tile_kernel(const QtQmmArgs a) {
  using L = QmLayout<BITS, XB>;
  extern __shared__ __align__(128) unsigned char qm_smem[];
  __shared__ int last_in;
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(qm_smem + QM_STAGES * L::STAGE);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;  // a warp's 32 x 32 of the tile
  const int gr = lane >> 2, tc = (lane & 3) * 2;

  // the item: tile blockIdx % tiles (row tiles of a column slice adjacent),
  // K run blockIdx / tiles (ops/cuda/qmm_tile.py::item)
  const int mt = (a.M + QM_BM - 1) / QM_BM, tiles = mt * ((a.N + QM_BN - 1) / QM_BN);
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int m0 = (tile % mt) * QM_BM, n0 = (tile / mt) * QM_BN;
  const int unit_k = max(a.gs, QM_BK), units = (a.K + unit_k - 1) / unit_k;
  const int k_begin = split * units / a.ks * unit_k;
  const int k_end = min((split + 1) * units / a.ks * unit_k, a.K);
  const int nst = (k_end - k_begin + QM_BK - 1) / QM_BK;
  const long long row_bytes = (long long)a.K * BITS / 8;
  int cw = 16;
  while (row_bytes % cw || (8 * BITS) % cw) cw >>= 1;

  float acc[2][4][4], P[2][4][4], X[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      X[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][e] = 0.f, P[i][j][e] = 0.f;
    }

#pragma unroll
  for (int s = 0; s < QM_STAGES - 1; ++s) {
    if (s < nst) qm_fetch<BITS, XB>(a, m0, n0, k_begin + s * QM_BK, cw, qm_smem + s * L::STAGE);
    qt_cp_commit();
  }
  for (int i = 0; i < nst; ++i) {
    qt_cp_wait<QM_STAGES - 2>();
    __syncthreads();  // step i landed; every warp is done with step i - 1 (its slot, the tile)
    const int j = i + QM_STAGES - 1;
    if (j < nst)
      qm_fetch<BITS, XB>(a, m0, n0, k_begin + j * QM_BK, cw, qm_smem + (j % QM_STAGES) * L::STAGE);
    qt_cp_commit();
    const unsigned char* st = qm_smem + (i % QM_STAGES) * L::STAGE;
    qm_unpack<BITS>(st + L::X_BYTES, wb);
    __syncthreads();  // the bf16 tile is whole
    const float* sb = reinterpret_cast<const float*>(st + L::X_BYTES + L::W_BYTES);
    const int k0 = k_begin + i * QM_BK;
#pragma unroll
    for (int c = 0; c < QM_BK / 16; ++c) {
      uint32_t bq[2][4];
      qm_ldsm_bn(bq[0], wb + wn * QM_LD + c * 16, QM_LD);
      qm_ldsm_bn(bq[1], wb + (wn + 16) * QM_LD + c * 16, QM_LD);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (m0 + wm + mi * 16 >= a.M) continue;  // warp-uniform: rows past M
        if constexpr (XB) {
          uint32_t af[4];
          const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
          qt_ldsm_a(af, xs + (wm + mi * 16) * QM_LD + c * 16, QM_LD);
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
            qt_mma(P[mi][nj], af, bq[nj >> 1][2 * (nj & 1)], bq[nj >> 1][2 * (nj & 1) + 1]);
          qt_mma(X[mi], af, QM_ONES, QM_ONES);
        } else {
          uint32_t hi[4], lo[4];
          qm_split_a(hi, lo, reinterpret_cast<const float*>(st) + (wm + mi * 16) * QM_LD + c * 16,
                     QM_LD);
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            qt_mma(P[mi][nj], hi, bq[nj >> 1][2 * (nj & 1)], bq[nj >> 1][2 * (nj & 1) + 1]);
            qt_mma(P[mi][nj], lo, bq[nj >> 1][2 * (nj & 1)], bq[nj >> 1][2 * (nj & 1) + 1]);
          }
          qt_mma(X[mi], hi, QM_ONES, QM_ONES);
          qt_mma(X[mi], lo, QM_ONES, QM_ONES);
        }
      }
      if ((k0 + (c + 1) * 16) % a.gs == 0) {  // a group ends: fold it (a group past K adds 0)
        const int js = a.gs == 32 ? c >> 1 : 0;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int n = wn + nj * 8 + tc;
          const float s0 = sb[js * QM_BN + n], s1 = sb[js * QM_BN + n + 1];
          const float b0 = sb[(2 + js) * QM_BN + n], b1 = sb[(2 + js) * QM_BN + n + 1];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            acc[mi][nj][0] += s0 * P[mi][nj][0] + b0 * X[mi][0];
            acc[mi][nj][1] += s1 * P[mi][nj][1] + b1 * X[mi][0];
            acc[mi][nj][2] += s0 * P[mi][nj][2] + b0 * X[mi][2];
            acc[mi][nj][3] += s1 * P[mi][nj][3] + b1 * X[mi][2];
#pragma unroll
            for (int e = 0; e < 4; ++e) P[mi][nj][e] = 0.f;
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) X[mi][e] = 0.f;
      }
    }
  }
  qt_cp_wait<0>();
  __syncthreads();  // the ring is free: stage the [64, 128] fp32 tile there

  float* ct = reinterpret_cast<float*>(qm_smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(ct + (wm + mi * 16 + gr + hf * 8) * QM_CLD + wn + nj * 8 + tc) =
            make_float2(acc[mi][nj][2 * hf], acc[mi][nj][2 * hf + 1]);
  __syncthreads();

  // four columns a thread, a row's 128 columns over 32 threads: coalesced
  const bool vec = a.N % 4 == 0;
  if (a.ks > 1) {  // partial sums; the tile's last arrival adds them up
    float* part = a.part + (long long)split * a.M * a.N;
    for (int idx = tid; idx < QM_BM * QM_BN / 4; idx += QM_NT) {
      const int r = idx >> 5, c = (idx & 31) * 4, m = m0 + r, n = n0 + c;
      if (m >= a.M || n >= a.N) continue;
      const float* v = ct + r * QM_CLD + c;
      float* d = part + (long long)m * a.N + n;
      if (vec)
        __stcg(reinterpret_cast<float4*>(d), *reinterpret_cast<const float4*>(v));
      else
        for (int e = 0; e < 4 && n + e < a.N; ++e) __stcg(d + e, v[e]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last_in = atomicAdd(a.cnt + tile, 1) == a.ks - 1;
      if (last_in) a.cnt[tile] = 0;  // no more arrivals at this tile in this launch
    }
    __syncthreads();
    if (!last_in) return;
    __threadfence();
    // sum = 0 + part[0] + ... + part[ks - 1] (the order, whoever arrives
    // last); a thread's 8 chunks of one partial are loaded together, so
    // each partial costs one L2 round trip
    constexpr int CH = QM_BM * QM_BN / 4 / QM_NT;
    float4 sum[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) sum[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < a.ks; ++q) {
      float4 v[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int idx = tid + j * QM_NT, r = idx >> 5, c = (idx & 31) * 4, m = m0 + r, n = n0 + c;
        const float* pq = a.part + ((long long)q * a.M + m) * a.N + n;
        v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m >= a.M || n >= a.N) continue;
        if (vec) {
          v[j] = __ldcg(reinterpret_cast<const float4*>(pq));
        } else {
          float e[4] = {0.f, 0.f, 0.f, 0.f};
          for (int i = 0; i < 4 && n + i < a.N; ++i) e[i] = __ldcg(pq + i);
          v[j] = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < CH; ++j)
        sum[j].x += v[j].x, sum[j].y += v[j].y, sum[j].z += v[j].z, sum[j].w += v[j].w;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int idx = tid + j * QM_NT, r = idx >> 5, c = (idx & 31) * 4, m = m0 + r, n = n0 + c;
      if (m < a.M && n < a.N) qm_store4(a, m, n, sum[j]);
    }
    return;
  }
  for (int idx = tid; idx < QM_BM * QM_BN / 4; idx += QM_NT) {
    const int r = idx >> 5, c = (idx & 31) * 4, m = m0 + r, n = n0 + c;
    if (m < a.M && n < a.N)
      qm_store4(a, m, n, *reinterpret_cast<const float4*>(ct + r * QM_CLD + c));
  }
}

template <int BITS, bool XB>
int qm_launch(const QtQmmArgs& a, cudaStream_t stream) {
  constexpr int smem = QmLayout<BITS, XB>::SMEM;
  static unsigned long long opted = 0;  // devices this kernel may use `smem` on
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !(opted >> dev & 1ull)) {
    e = cudaFuncSetAttribute(qt_qmm_tile_kernel<BITS, XB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted |= 1ull << dev;
  }
  const int tiles = ((a.M + QM_BM - 1) / QM_BM) * ((a.N + QM_BN - 1) / QM_BN);
  qt_qmm_tile_kernel<BITS, XB><<<tiles * a.ks, QM_NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// One call of the tile (the C entries launch it for M > m0).
template <int BITS>
int qt_qmm_tile(const QtQmmArgs& a, cudaStream_t stream) {
  const int G = a.gs > 0 ? a.K / a.gs : 0;
  if ((a.gs != 32 && a.gs != 64 && a.gs != 128) || a.K % 32 || G * a.gs != a.K || a.ks < 1 ||
      (a.ks > 1 && (!a.part || !a.cnt)) ||
      a.ks > (a.K + max(a.gs, QM_BK) - 1) / max(a.gs, QM_BK))
    return (int)cudaErrorInvalidValue;
  return a.x_bf16 ? qm_launch<BITS, true>(a, stream) : qm_launch<BITS, false>(a, stream);
}

}  // namespace
