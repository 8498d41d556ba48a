// Tensor-core building blocks for the bf16 kernels: inline PTX for
// Ampere-style warp-level products (`mma.sync` m16n8k16, bf16 in, f32
// accumulate), `ldmatrix` fragment loads, and `cp.async` 16-byte copies
// from device to shared memory, plus the warp-level attention tiles that
// K5, K6 and K13 (attention.cu), K8 (flash_train.cu) and K14 (mha.cu)
// share, and three warp-level GEMM tiles: C += A^T . B (the contraction
// down the rows of both operands) that K11 (dense.cu) and K7's weight
// gradients run, C += A . B that K6's and K7's projections run, and C += A
// . B^T that K7's dx runs (flash_train.cu).
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with lane = 4 * grp + tig:
//   A [16 x 16] row-major, 4 registers of 2 bf16: a0 (row grp, cols
//     2tig, 2tig+1), a1 (row grp+8, same cols), a2 (row grp, cols
//     2tig+8, +9), a3 (row grp+8, cols 2tig+8, +9);
//   B [16 x 8] "col": b0 (k 2tig, 2tig+1, col grp), b1 (k 2tig+8, +9);
//   C/D [16 x 8] f32: c0, c1 (row grp, cols 2tig, 2tig+1), c2, c3 (row
//     grp+8, same cols).
// So two adjacent n8 accumulator tiles of a product, rounded to bf16,
// are one k16 A fragment of the next product (P.V takes p this way).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <math_constants.h>

namespace vpt {
namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes device -> shared memory, asynchronously; with `valid` false
// nothing is read (src-size 0) and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The same for a count known only at run time; above 7 it waits for 7
// (stricter, so still safe).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] holds this lane's pair of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// The same, each matrix transposed on the way (B fragments of a
// row-major [k, n] tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a . b on the tensor cores: [16 x 16] bf16 by [16 x 8] bf16, f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to nearest-even bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + R) of a row-major bf16 matrix (W values a row, rows
// `stride` elements apart) -> shared rows of `ld` elements, as 16-byte
// cp.async issued by THREADS threads; rows at or past `rows`, and the
// 8-column chunks at or past `cols` (a multiple of 8), are zero-filled,
// never read (their source stays at `src`, which exists).
template <int W, int R, int THREADS>
__device__ __forceinline__ void cp_rows(bf16* dst, int ld, const bf16* src, size_t stride,
                                        int r0, int rows, int tid, int cols = W) {
  constexpr int CPR = W / 8;  // 16-byte chunks a row
  constexpr int N = R * CPR;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    if (N % THREADS != 0 && c >= N) break;
    const int r = c / CPR, cc = c - r * CPR;
    const bool valid = r0 + r < rows && cc * 8 < cols;
    cp_async16(dst + r * ld + cc * 8, src + (valid ? (size_t)(r0 + r) * stride + cc * 8 : 0),
               valid);
  }
}

// 2^x by the hardware's approximation (ex2.approx.ftz: within 2 ulp of
// 2^x, results below 2^-126 flushed to 0). The attention tiles keep their
// logits in log2 units, t = s * scale * log2(e), so that exp(s * scale -
// max) = 2^(t - max t) costs one subtraction and this one instruction.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.44269504088896341f;
constexpr float LN2 = 0.693147180559945309f;

// ------------------------------------------------ warp-level attention
// A warp owns MT tiles of 16 query rows; keys come in tiles of KT = 64
// rows in shared memory, each row padded to its width + 8 bf16 so that
// the 8 row addresses of an ldmatrix fall on 8 different 16-byte bank
// groups. Each B fragment read from shared memory serves the warp's MT
// row tiles.
constexpr int KT = 64;
constexpr int NT = KT / 8;  // n8 tiles of a key tile

// The warp's A fragments of q: row tile mt is rows row0 + 16 mt.. of a
// shared [rows x DH] tile.
template <int DH, int MT>
__device__ __forceinline__ void warp_a_frags(uint32_t (&qa)[MT][DH / 16][4], const bf16* qs,
                                             int ld, int row0, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      ldmatrix_x4(qa[mt][ks],
                  qs + (row0 + 16 * mt + (lane & 15)) * ld + ks * 16 + (lane >> 4) * 8);
}

// s = q . k^T of the warp's rows against a key tile [8 N8 x DH] (N8 = NT:
// KT keys): s[mt][n] is the accumulator of row tile mt and keys 8n..8n+7.
// A fixed instruction sequence (k steps in order), so the same inputs give
// the same bits.
template <int DH, int MT, int N8 = NT>
__device__ __forceinline__ void warp_scores(float (&s)[MT][N8][4],
                                            const uint32_t (&qa)[MT][DH / 16][4], const bf16* kt,
                                            int ld, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < N8; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
    for (int np = 0; np < N8 / 2; ++np) {
      // matrices: keys 16np+0..7 at k lo, hi; keys 16np+8..15 at k lo, hi
      uint32_t b[4];
      ldmatrix_x4(b, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld + ks * 16 +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * np], qa[mt][ks], b[0], b[1]);
        mma_bf16(s[mt][2 * np + 1], qa[mt][ks], b[2], b[3]);
      }
    }
}

// The logits s * c (c = scale * LOG2E: in log2 units); keys at or past
// `end` (key t0 is the tile's first) get -inf.
__device__ __forceinline__ void scale_and_mask(float (&s)[NT][4], float c, int t0, int end,
                                               int lane) {
  const bool ragged = t0 + KT > end;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = __fmul_rn(s[n][e], c);
      if (ragged && t0 + 8 * n + 2 * (lane & 3) + (e & 1) >= end) s[n][e] = -CUDART_INF_F;
    }
}

// Each of the thread's two rows' (grp, grp+8) maximum over a row tile's
// keys, combined over the 4 lanes that share the rows.
__device__ __forceinline__ void tile_max(const float (&s)[NT][4], float (&mx)[2]) {
  mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// The sum of a per-lane partial over the 4 lanes of a row (the same
// bits in all four: each step adds two operands in either order).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One 64-key tile of the online softmax for a warp's MT row tiles: s
// holds the tile's logits in log2 units (scaled and masked), mx and sum
// the rows' running max and this lane's share of the running sum, o the
// P.V accumulators. m_new = max(mx, the tile's max), corr = 2^(mx -
// m_new), p = 2^(s - m_new) in f32 (back into s), sum = sum * corr + the
// unrounded p, o *= corr; the caller rounds p into P.V's A fragments.
template <int MT, int DV>
__device__ __forceinline__ void online_softmax_tile(float (&s)[MT][NT][4], float (&mx)[MT][2],
                                                    float (&sum)[MT][2],
                                                    float (&o)[MT][DV / 8][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float tm[2], corr[2], ps[2] = {0.0f, 0.0f};
    tile_max(s[mt], tm);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float nm = fmaxf(mx[mt][r], tm[r]);
      corr[r] = exp2_approx(mx[mt][r] - nm);  // 0 on the first tile
      mx[mt][r] = nm;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mt][n][e] = exp2_approx(s[mt][n][e] - mx[mt][e >> 1]);  // p
        ps[e >> 1] += s[mt][n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) sum[mt][r] = sum[mt][r] * corr[r] + ps[r];
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] *= corr[e >> 1];
  }
}

// p of a row tile over 8 N8 keys, rounded to bf16, as the N8 / 2 k16 A
// fragments of P.V.
template <int N8>
__device__ __forceinline__ void p_frags(uint32_t (&pa)[N8 / 2][4], const float (&p)[N8][4]) {
#pragma unroll
  for (int kk = 0; kk < N8 / 2; ++kk) {
    pa[kk][0] = pack_bf16x2(p[2 * kk][0], p[2 * kk][1]);
    pa[kk][1] = pack_bf16x2(p[2 * kk][2], p[2 * kk][3]);
    pa[kk][2] = pack_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// o += p . v over a key tile: v [16 KK x DV] (KK = KT / 16: KT keys)
// row-major in shared memory, read as B fragments through ldmatrix.trans;
// o[mt][n] holds row tile mt, columns 8n..8n+7.
template <int DV, int MT, int KK = KT / 16>
__device__ __forceinline__ void warp_pv(float (&o)[MT][DV / 8][4],
                                        const uint32_t (&pa)[MT][KK][4], const bf16* vt,
                                        int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int dp = 0; dp < DV / 16; ++dp) {
      // matrices: keys 16kk+0..7, 16kk+8..15 at columns 16dp..; the same
      // at columns 16dp+8..
      uint32_t b[4];
      ldmatrix_x4_trans(b, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + dp * 16 +
                               (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * dp], pa[mt][kk], b[0], b[1]);
        mma_bf16(o[mt][2 * dp + 1], pa[mt][kk], b[2], b[3]);
      }
    }
}

// ------------------------------------------------ warp-level GEMM
// C += A^T . B for one warp, the contraction down the rows of both
// operands (a weight gradient x^T . dy): A is a [k x 16 MI] tile and B a
// [k x 8 NI] tile, both row-major bf16 in shared memory, rows `lda` and
// `ldb` elements apart (padded to width + 8 so that ldmatrix meets no
// bank conflict), k a multiple of 16. c[i][j] is the f32 accumulator of
// rows 16i.. and columns 8j.. of C [16 MI x 8 NI]. Both operands come
// through ldmatrix.trans: the A tile, transposed on the way, is the
// row-major [m x k] A fragment; the B tile is the "col" B fragment, as
// warp_pv reads v. With SUMB, cs[j] += ones . B too, so that every row of
// cs holds B's column sums over the k rows (a bias gradient from the
// fragments already loaded). The k steps run in order: the same inputs
// give the same bits.
template <int MI, int NI, bool SUMB>
__device__ __forceinline__ void warp_atb(float (&c)[MI][NI][4], float (&cs)[NI][4],
                                         const bf16* a, int lda, const bf16* b, int ldb, int k,
                                         int lane) {
  static_assert(NI % 2 == 0, "B fragments come in pairs of n8 tiles");
  constexpr uint32_t ONES = 0x3f803f80u;  // two bf16 1.0
  const uint32_t ones[4] = {ONES, ONES, ONES, ONES};
  for (int k0 = 0; k0 < k; k0 += 16) {
    uint32_t af[MI][4], bf[NI / 2][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      // matrices: (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
      ldmatrix_x4_trans(af[i], a + (k0 + (lane & 7) + (lane >> 4) * 8) * lda + 16 * i +
                                   ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int j = 0; j < NI / 2; ++j)
      // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
      ldmatrix_x4_trans(bf[j], b + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + 16 * j +
                                   (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        mma_bf16(c[i][2 * j], af[i], bf[j][0], bf[j][1]);
        mma_bf16(c[i][2 * j + 1], af[i], bf[j][2], bf[j][3]);
      }
    if (SUMB) {
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        mma_bf16(cs[2 * j], ones, bf[j][0], bf[j][1]);
        mma_bf16(cs[2 * j + 1], ones, bf[j][2], bf[j][3]);
      }
    }
  }
}

// C += A . B for one warp: A a [16 MI x k] tile and B a [k x 8 NI] tile,
// both row-major bf16 in shared memory, rows `lda` and `ldb` elements
// apart (padded so that ldmatrix meets no bank conflict), k a multiple of
// 16. A comes through ldmatrix as warp_a_frags reads q, B through
// ldmatrix.trans as warp_pv reads v; c[i][j] is the f32 accumulator of
// rows 16i.. and columns 8j.. of C. The k steps run in order: the same
// inputs give the same bits.
template <int MI, int NI>
__device__ __forceinline__ void warp_ab(float (&c)[MI][NI][4], const bf16* a, int lda,
                                        const bf16* b, int ldb, int k, int lane) {
  static_assert(NI % 2 == 0, "B fragments come in pairs of n8 tiles");
  for (int k0 = 0; k0 < k; k0 += 16) {
    uint32_t af[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      ldmatrix_x4(af[i], a + (16 * i + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NI / 2; ++j) {
      // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + 16 * j +
                                (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma_bf16(c[i][2 * j], af[i], bf[0], bf[1]);
        mma_bf16(c[i][2 * j + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

// C += A . B^T for one warp: A a [16 MI x k] tile and B a [8 NI x k] tile
// (B's rows are C's columns), both row-major bf16 in shared memory, rows
// `lda` and `ldb` elements apart, k a multiple of 16. Both come through
// ldmatrix without .trans: a row-major [n x k] tile is the "col" B
// fragment, as warp_scores reads k. c[i][j] is the f32 accumulator of rows
// 16i.. and columns 8j.. of C. The k steps run in order: the same inputs
// give the same bits.
template <int MI, int NI>
__device__ __forceinline__ void warp_abt(float (&c)[MI][NI][4], const bf16* a, int lda,
                                         const bf16* b, int ldb, int k, int lane) {
  static_assert(NI % 2 == 0, "B fragments come in pairs of n8 tiles");
  for (int k0 = 0; k0 < k; k0 += 16) {
    uint32_t af[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      ldmatrix_x4(af[i], a + (16 * i + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NI / 2; ++j) {
      // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * ldb + k0 +
                          ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma_bf16(c[i][2 * j], af[i], bf[0], bf[1]);
        mma_bf16(c[i][2 * j + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

}  // namespace mma
}  // namespace vpt
