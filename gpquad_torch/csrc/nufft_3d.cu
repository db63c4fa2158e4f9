// Fused d=3 NUFFT kernels for Hopper (sm_90a), written by hand.
//
//   nufft2_3d (type-2, uniform -> points) replaces pallas_nufft2_3d and its
//   first-dimension slab-tiled variant _pallas_nufft2_3d_tiled
//   (gpquad/ops/pallas_nufft.py):
//       out[b,n] = sum_{j1} e1(n,j1) sum_{j2} e2(n,j2) sum_{j3} e3(n,j3)
//                  f[b,j1,j2,j3],            e = e^{+2 pi i c}
//   nufft1_3d (type-1, points -> uniform) replaces pallas_nufft1_3d and its
//   slab-tiled variant _pallas_nufft1_3d_tiled:
//       out[b,j1,j2,j3] = sum_n (v[b,n] e1(n,j1)) e2(n,j2) e3(n,j3),
//                                             e = e^{-2 pi i c}
//
// c_t(n,j) is the phase in cycles of point n along dimension t at mode k_j,
// made on the fly as nufft_common.cuh describes.  Nothing of size N x mtot
// reaches device memory.  One kernel per type takes any odd mtot, so the
// TPU's single-block (mtot <= 56) and slab-tiled (mtot <= 256) variants are
// both covered; the batch is a grid axis, so the gradient's probe batches are
// one launch.
//
// What bounds them on an H100: per point and vector both do mtot^3 complex
// multiply-adds (8 flops each) against 12 bytes of point data and 8 bytes of
// value, so they are bound by operations (fp32 outside the tensor cores), not
// by bytes.  At mtot 61 that is 227k multiply-adds per point.  The float32
// paths the geometry sends there run on the tensor cores (3xTF32); the
// CUDA-core kernel keeps the multiply-adds in registers fed by broadcast
// reads of shared memory, and makes each phase a small share of them:
//
//  - nufft2_3d in float32 (where ops/cuda_nufft.py type2_3d_geometry sends
//    it): tc_type2.cuh's tensor-core kernel (3xTF32) on Type2Grid3D below,
//    a GEMM over the points' (j2, j3) phases whose columns are (b, j1),
//    the sum over j1 in its epilogue;
//  - nufft2_3d in float64: tc_type2_f64.cuh's FP64 tensor-core kernel
//    (DMMA, no split of the operands) on Type2F64Grid3D below, the same
//    GEMM over the pairs (j2, j3) and epilogue over j1, the modes j3 padded
//    to whole k-steps of 8 and each axis's mode split so that a point makes
//    few phases a k-step;
//  - nufft2_3d on the CUDA cores (the float32 shapes the geometry keeps
//    there, and the control phase 3 times beside the tensor cores): one
//    point per thread (or per G threads, below).  For a tile
//    of TK third-axis modes the point's e3 phases live in registers; for a
//    slab of TJ1 first-axis modes the thread keeps TJ1 partial sums
//    u[j1] = sum_{j2} e2(j2) sum_{j3 in tile} e3(j3) f[j1,j2,j3]; the f tile
//    (TJ1 x TJ2 x TK) is staged in shared memory and read as a broadcast.
//    Each e2 phase is made once per (slab, tile) and serves TJ1 rows, each e1
//    phase once per (slab, tile) when the slab's sums are folded into the
//    point's accumulator.  The j1 loop is a loop inside the block: no
//    cross-block sum.  When the points are few (n * B < 65536, e.g. 1e4
//    targets) G = 4 threads share a point, each taking every G-th second-axis
//    mode of the staged tile, and their sums are added in a fixed order in
//    shared memory at the end, so that enough warps fill the card.
//  - nufft1_3d in float32 (where ops/cuda_nufft.py type1_3d_geometry sends
//    it, mtot up to 64): tc_type1.cuh's tensor-core kernel (3xTF32) on
//    Type1Grid3D below, a GEMM over the points whose rows are (r, j3) and
//    columns (q, j2) of a split of the first axis's mode, k1 = S q + r;
//    past 64 tc_type1_wide.cuh's kernel (3xTF32), the same GEMM with rows
//    the pairs (j1, j2) laid end to end and columns j3, each operand's
//    entry a product of a per-tile table's factors;
//  - nufft1_3d in float64: tc_type1_f64.cuh's FP64 tensor-core kernel
//    (DMMA, no split of the operands) on Type1F64Grid3D below, the same
//    rows (r, j3) and columns (q, j2) of k1 = S q + r with S picked per
//    width by ops/cuda_nufft.py type1_3d_geometry, each index's inner mode
//    split again so that a point makes few phases a tile.
//
// The CUDA-core kernel is the float32 type-2's alone.
//
// C interface (bound with ctypes): pointers and the stream are void*, each
// function returns cudaGetLastError() after its launches.

#include <algorithm>

#include "tc_type1_f64.cuh"
#include "tc_type1_wide.cuh"
#include "tc_type2.cuh"
#include "tc_type2_f64.cuh"

namespace {

// ---------------------------------------------------------------------------
// type-2: block = P = THREADS / G points x G threads per point, one vector b
// (grid axis y).  Thread (p, g) = (tid % P, tid / P), so the 32 threads of a
// warp hold 32 points and read the same shared f entry (a broadcast).
// ---------------------------------------------------------------------------
template <typename T, int THREADS, int G, int TJ1, int TJ2, int TK>
__global__ void __launch_bounds__(THREADS)
nufft2_3d_kernel(const T* __restrict__ x, const v2_t<T>* __restrict__ f,
                 T h, int n, int m, int fft_order,
                 v2_t<T>* __restrict__ out) {
  constexpr int P = THREADS / G;
  __shared__ v2_t<T> ftile[TJ1][TJ2][TK];
  __shared__ v2_t<T> red[G][P];
  const int p = threadIdx.x % P;
  const int g = threadIdx.x / P;
  const int i = blockIdx.x * P + p;
  const bool live = i < n;
  const size_t mm = (size_t)m * m;
  const v2_t<T>* fb = f + (size_t)blockIdx.y * mm * m;
  T u1 = 0, u2 = 0, u3 = 0;
  if (live) {
    u1 = torus(x[3 * (size_t)i], h);
    u2 = torus(x[3 * (size_t)i + 1], h);
    u3 = torus(x[3 * (size_t)i + 2], h);
  }
  T acc_re = 0, acc_im = 0;
  for (int k0 = 0; k0 < m; k0 += TK) {
    T c3[TK], s3[TK];
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      if (k0 + kk < m) {
        phase(u3, mode_value<T>(k0 + kk, m, fft_order), &c3[kk], &s3[kk]);
      } else {
        c3[kk] = 0;
        s3[kk] = 0;
      }
    }
    for (int j10 = 0; j10 < m; j10 += TJ1) {
      T ur[TJ1], ui[TJ1];
#pragma unroll
      for (int a = 0; a < TJ1; ++a) {
        ur[a] = 0;
        ui[a] = 0;
      }
      for (int j20 = 0; j20 < m; j20 += TJ2) {
        __syncthreads();
        for (int e = threadIdx.x; e < TJ1 * TJ2 * TK; e += THREADS) {
          const int a = e / (TJ2 * TK), r = e % (TJ2 * TK);
          const int jj = r / TK, kk = r % TK;
          const int j1 = j10 + a, j2 = j20 + jj, k = k0 + kk;
          v2_t<T> val;
          val.x = 0;
          val.y = 0;
          if (j1 < m && j2 < m && k < m) val = fb[(size_t)j1 * mm + (size_t)j2 * m + k];
          ftile[a][jj][kk] = val;
        }
        __syncthreads();
        const int jn2 = min(TJ2, m - j20);
        for (int jj = g; jj < jn2; jj += G) {
          T c2, s2;
          phase(u2, mode_value<T>(j20 + jj, m, fft_order), &c2, &s2);
#pragma unroll
          for (int a = 0; a < TJ1; ++a) {
            T tr = 0, ti = 0;
#pragma unroll
            for (int kk = 0; kk < TK; ++kk) {
              const v2_t<T> v = ftile[a][jj][kk];
              tr = fma(v.x, c3[kk], fma(-v.y, s3[kk], tr));
              ti = fma(v.x, s3[kk], fma(v.y, c3[kk], ti));
            }
            ur[a] = fma(c2, tr, fma(-s2, ti, ur[a]));
            ui[a] = fma(c2, ti, fma(s2, tr, ui[a]));
          }
        }
      }
      const int jn1 = min(TJ1, m - j10);
#pragma unroll
      for (int a = 0; a < TJ1; ++a) {
        if (a < jn1) {   // uniform over the block
          T c1, s1;
          phase(u1, mode_value<T>(j10 + a, m, fft_order), &c1, &s1);
          acc_re = fma(c1, ur[a], fma(-s1, ui[a], acc_re));
          acc_im = fma(c1, ui[a], fma(s1, ur[a], acc_im));
        }
      }
    }
  }
  if constexpr (G > 1) {
    red[g][p].x = acc_re;
    red[g][p].y = acc_im;
    __syncthreads();
    if (g == 0) {
      acc_re = 0;
      acc_im = 0;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        acc_re += red[gg][p].x;
        acc_im += red[gg][p].y;
      }
    }
  }
  if (live && g == 0) {
    v2_t<T> o;
    o.x = acc_re;
    o.y = acc_im;
    out[(size_t)blockIdx.y * n + i] = o;
  }
}

// Type-2: 128 threads per block; one thread per point when there are many
// points, four when there are few; TK = 32 third-axis modes per register
// tile (16 KB of shared memory).
constexpr int T2_THREADS = 128;
constexpr int T2_FEW_POINTS = 65536;

template <int G>
int launch_nufft2_g(const void* x, const void* f, float h, int n, int m,
                    int nb, int fft_order, void* out, cudaStream_t s) {
  constexpr int P = T2_THREADS / G;
  const dim3 grid((n + P - 1) / P, nb);
  nufft2_3d_kernel<float, T2_THREADS, G, 8, 8, 32>
      <<<grid, T2_THREADS, 0, s>>>((const float*)x, (const float2*)f, h, n,
                                   m, fft_order, (float2*)out);
  return (int)cudaGetLastError();
}

int launch_nufft2(const void* x, const void* f, float h, int n, int m, int nb,
                  int fft_order, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)n * nb < T2_FEW_POINTS)
    return launch_nufft2_g<4>(x, f, h, n, m, nb, fft_order, out, s);
  return launch_nufft2_g<1>(x, f, h, n, m, nb, fft_order, out, s);
}

// ---------------------------------------------------------------------------
// type-1 in float32 on the tensor cores: tc_type1.cuh's kernel on the d=3
// problem.  gpquad factors the sum as a product over the points per j1
// (pallas_nufft.py:703-745, dot(uj.T, c3)); here the first axis's mode is
// split as k1 = S q + r (r in 0..S-1, S = TJ / mtot where a tile's TJ rows
// a vector hold two or more blocks of mtot, else 1), and
//   out[(r, j3), (q, j2)] = sum_p (v_p e^{-2 pi i r u1} e3(j3))
//                                 (e^{-2 pi i S q u1} e2(j2)):
// rows (r, j3), S mtot of them, columns (q, j2), Q mtot of them (Q the
// values of q that reach every |k1| <= half); outputs with |k1| past half
// are cropped.  Each phase is the product of two folded phases (phase()
// of the torus coordinate): a row's e3(j3) directly (phase of u3), its
// e^{-2 pi i r u1} and a column's two from a table the producers make once
// a stage for the tile: [0, S) e^{-2 pi i r u1}; [S, S + nq) e^{-2 pi i S q
// u1} at the tile's nq values of q; then e2 at the min(mtot, COLS) modes
// j2 = (k0 + t) % mtot, t = 0.. (column k0 + b has j2 at t = b % mtot).
// The column tiles are wide (128) up to mtot 64, where the table holds at
// most 67 entries, and 32 past (35): the geometry (ops/cuda_nufft.py
// type1_3d_geometry) keeps to that.  With rows (j1, j2) and columns j3 a
// tile's columns were one axis's mtot modes, at most 32 of them at the
// driven widths, and the producers, which remade e3 and the row table for
// every row tile, held the kernel at 1.8-2.4x the CUDA cores' time
// (scripts/time_type1_3d.py).
// ---------------------------------------------------------------------------
struct Type1Grid3D {
  using X = float3;
  using Acc = float;
  struct Row {
    int ir;       // e^{-2 pi i r u1} in the table
    float k3;     // the mode value of j3
  };
  struct Col {
    int iq, i2;   // e^{-2 pi i S q u1} and e2(j2) in the table
  };
  static constexpr int kTab = 72;
  template <int TJ>
  static __host__ __device__ int split(int m) {
    return TJ >= 2 * m ? TJ / m : 1;
  }
  static __host__ __device__ int qmin(int m, int S) {
    return -(((m - 1) / 2 + S - 1) / S);
  }
  static __host__ __device__ int qcount(int m, int S) {
    return (m - 1) / 2 / S - qmin(m, S) + 1;
  }
  static __device__ void point(X xp, float h, float* a, float* b, float* c) {
    *a = torus(xp.x, h);
    *b = torus(xp.y, h);
    *c = torus(xp.z, h);
  }
  // the values of q that the column tile from k0 reaches
  template <int TJ, int COLS>
  static __device__ int tab_q(int k0, int m) {
    const int nc = qcount(m, split<TJ>(m)) * m;
    return min(k0 + COLS - 1, nc - 1) / m - k0 / m + 1;
  }
  template <int TJ>
  static __device__ Row row_mode(int i, int m, int fft_order, bool* ok) {
    *ok = i < split<TJ>(m) * m;
    return Row{i / m, mode_value<float>(i % m, m, fft_order)};
  }
  template <int TJ, int COLS>
  static __device__ Col col_mode(int c, int m, int, bool* ok) {
    const int S = split<TJ>(m);
    *ok = c < qcount(m, S) * m;
    const int k0 = c - c % COLS;
    return Col{S + c / m - k0 / m, S + tab_q<TJ, COLS>(k0, m) + (c - k0) % m};
  }
  // the stage's table for the tile (rows from j0, columns from k0): thread
  // ptid makes entries ptid % 8 + 8 i of point ptid / 8
  template <int TJ, int COLS>
  static __device__ void tab_fill(float2* tab, const float* u1,
                                  const float* u2, const float*, int, int k0,
                                  int m, int fft_order, int ptid) {
    static_assert(TC_THREADS - TC_CONSUMERS == 8 * TC_P && kTab % 8 == 0,
                  "eight producers a point");
    const int S = split<TJ>(m);
    const int q0 = qmin(m, S) + k0 / m;
    const int nq = tab_q<TJ, COLS>(k0, m);
    const int nt = S + nq + min(m, COLS);
    const int q = ptid / 8;
#pragma unroll
    for (int i = 0; i < kTab / 8; ++i) {
      const int t = ptid % 8 + 8 * i;
      if (t < nt) {
        float u, kv;
        if (t < S) {
          u = u1[q];
          kv = (float)t;
        } else if (t < S + nq) {
          u = u1[q];
          kv = (float)(S * (q0 + t - S));
        } else {
          u = u2[q];
          kv = mode_value<float>((k0 + t - S - nq) % m, m, fft_order);
        }
        float c, s;
        phase(u, kv, &c, &s);
        tab[q * kTab + t] = make_float2(c, s);
      }
    }
  }
  // (c1 + i s1)(c2 + i s2) of two e^{-2 pi i c} as cos and sin of the sum
  static __device__ void prod(float2 a, float2 b, float* c, float* s) {
    *c = fmaf(a.x, b.x, -a.y * b.y);
    *s = fmaf(a.y, b.x, a.x * b.y);
  }
  static __device__ void row_phase(float, float, float u3, const float2* tab,
                                   Row r, float* c, float* s) {
    float2 e3;
    phase(u3, r.k3, &e3.x, &e3.y);
    prod(tab[r.ir], e3, c, s);
  }
  static __device__ void col_phase(float, float, float, const float2* tab,
                                   Col k, float* c, float* s) {
    prod(tab[k.iq], tab[k.i2], c, s);
  }
  // whether every column tile's table fits in kTab entries (the launch
  // refuses a geometry where it does not)
  template <int TJ, int COLS>
  static bool tab_fits(int m) {
    const int S = split<TJ>(m), nc = qcount(m, S) * m;
    for (int k0 = 0; k0 < nc; k0 += COLS) {
      const int nq = std::min(k0 + COLS - 1, nc - 1) / m - k0 / m + 1;
      if (S + nq + std::min(m, COLS) > kTab) return false;
    }
    return true;
  }
  template <int TJ>
  static __host__ __device__ int rows(int m) { return split<TJ>(m) * m; }
  template <int TJ>
  static __host__ __device__ int cols(int m) {
    return qcount(m, split<TJ>(m)) * m;
  }
  static __host__ __device__ long long outputs(int m) {
    return (long long)m * m * m;
  }
  template <int TJ>
  static __device__ long long out_index(int i, int c, int m, int fft_order) {
    const int S = split<TJ>(m);
    const int half = (m - 1) / 2;
    const int k1 = S * (qmin(m, S) + c / m) + i / m;
    if (i >= S * m || c >= qcount(m, S) * m || k1 < -half || k1 > half)
      return -1;
    const int j1 = fft_order ? (k1 >= 0 ? k1 : k1 + m) : k1 + half;
    return ((long long)j1 * m + c % m) * m + i % m;
  }
};

// ---------------------------------------------------------------------------
// type-1 in float64 on the FP64 tensor cores: tc_type1_f64.cuh's kernel on
// the d=3 problem, with Type1Grid3D's split of the first axis's mode,
// k1 = S q + r (r in 0..S-1, q from qmin, Q values of it), and
//   out[(r, j3), (q, j2)] = sum_p (v_p e(u1, r) e3(j3)) (e(u1, S q) e2(j2)):
// row i is (r, j3) = (i / mi, i % mi), column c (q, j2) = (c / mi, c % mi),
// mi = mtot (8 below 8, so that a group of 8 indices spans at most two
// values of r or q; the indices past mtot are padding).  The inner mode of
// a row is j3 - half of u3, its outer factor e(u1, r); of a column j2 -
// half of u2 and e(u1, S q).  S is the caller's (ops/cuda_nufft.py
// type1_3d_geometry picks the S in 1..8 whose tiles pad the rows and
// columns least: at mtot 21 rows 3 x 21 and columns 8 x 21 against 21 and
// 21 x 21, where 64-row tiles of j3 alone would be two thirds padding);
// outputs with |k1| past half are cropped.
// ---------------------------------------------------------------------------
struct Type1F64Grid3D {
  struct X {
    double x, y, z;
  };
  static constexpr int kCoords = 3, kRowCoord = 2, kColCoord = 1;
  static constexpr bool kOuter = true;
  static constexpr bool kCarry = false;
  // the modes of the rows' and the columns' index 0 (of an outer value)
  static __device__ int row_base(int m, int) { return -((m - 1) / 2); }
  static __device__ int col_base(int m, int) { return -((m - 1) / 2); }
  static constexpr int kMaxSplit = 8;
  // the fine factors, two coarse ones a group at most, and the outer
  // values a tile's rows and columns reach
  template <int S1, int S2>
  static __host__ __device__ constexpr int max_factors() {
    return 2 * T64_K + 2 * (S1 + S2) + (S1 + 1) + (S2 + 1);
  }
  template <int S1, int S2>
  static __host__ __device__ constexpr int fixed_factors() { return 0; }
  static __device__ double coord(const X& p, int c) {
    return c == 0 ? p.x : c == 1 ? p.y : p.z;
  }
  static __host__ __device__ int inner(int m) {
    return m >= T64_K ? m : T64_K;
  }
  static __host__ __device__ int qcount(int m, int S) {
    return Type1Grid3D::qcount(m, S);
  }
  static __device__ int row_outer(int o, int, int) { return o; }
  static __device__ int col_outer(int o, int m, int S) {
    return S * (Type1Grid3D::qmin(m, S) + o);
  }
  static bool split_ok(int, int S) { return S >= 1 && S <= kMaxSplit; }
  static __host__ __device__ int rows(int m, int S) { return S * inner(m); }
  static __host__ __device__ int cols(int m, int S) {
    return qcount(m, S) * inner(m);
  }
  static __host__ __device__ long long outputs(int m) {
    return (long long)m * m * m;
  }
  static __device__ long long out_index(int i, int c, int m, int S,
                                        int fft_order) {
    const int mi = inner(m), half = (m - 1) / 2;
    const int r = i / mi, j3 = i - r * mi, q = c / mi, j2 = c - q * mi;
    const int k1 = S * (Type1Grid3D::qmin(m, S) + q) + r;
    if (r >= S || j3 >= m || q >= qcount(m, S) || j2 >= m || k1 < -half ||
        k1 > half)
      return -1;
    const int j1 = fft_order ? (k1 >= 0 ? k1 : k1 + m) : k1 + half;
    return ((long long)j1 * m + t64_out(j2, m, fft_order)) * m +
           t64_out(j3, m, fft_order);
  }
};

// ---------------------------------------------------------------------------
// type-2 in float32 on the tensor cores: tc_type2.cuh's kernel on the d=3
// problem.  gpquad contracts only j3 on the MXU (pallas_nufft.py
// _type2_3d_kernel, dot(fre, c3.T)) and leaves mtot^2 products a point and
// vector to the VPU; here the GEMM's reduction runs over the pairs (j2,
// j3), j3 padded to J3 = a multiple of 32 so that a stage of 32 modes is
// one j2 and 32 modes j3, in the order k = (jb m + j2) 32 + j3 % 32 (jb =
// j3 / 32): a run of m stages holds one block of 32 modes j3.
//   eA(p, k) = e2(p, j2) e3(p, j3), the product of two folded phases
//   (phase() of the torus coordinate, as the CUDA-core kernel makes each):
//   tc_type2.cuh's per-stage phase source makes e2 once a stage at a
//   thread's two points and e3 once a run at its quads' modes;
//   the columns are (b, j1), each vector's j1 padded to a multiple of 32,
//   in tiles of 32 or 64; eE = e1.
// The reduction is long (m J3 modes: 992 at mtot 31, 3 904 at 61), so the
// stages of a column tile are many; for few points the launch splits them
// over a grid axis (kSplitK; ops/cuda_nufft.py type2_3d_geometry).
// ---------------------------------------------------------------------------
struct Type2Grid3D {
  using X = float3;
  static constexpr bool kWholeStages = true;   // red_len: multiples of 32
  static constexpr bool kStagePhases = true;
  static constexpr bool kSplitK = true;
  static __host__ __device__ int j3_len(int m) { return (m + 31) / 32 * 32; }
  static __device__ void point(X xp, float h, float* a, float* b, float* c) {
    *a = torus(xp.x, h);
    *b = torus(xp.y, h);
    *c = torus(xp.z, h);
  }
  static __device__ int inner_run(int st, int m) { return st / m; }
  static __device__ float inner_mode(int run, int kk, int m, int fft_order,
                                     bool* ok) {
    const int j3 = run * T2C_KS + kk;
    *ok = j3 < m;
    return mode_value<float>(j3, m, fft_order);
  }
  static __device__ float outer_mode(int st, int m, int fft_order) {
    return mode_value<float>(st % m, m, fft_order);
  }
  static __device__ void inner_phase(float, float, float u3, float kv,
                                     float* c, float* s) {
    phase(u3, kv, c, s);
  }
  static __device__ void outer_phase(float, float u2, float, float kv,
                                     float* c, float* s) {
    phase(u2, kv, c, s);
  }
  static __device__ void prod(float2 a, float2 b, float* c, float* s) {
    Type1Grid3D::prod(a, b, c, s);
  }
  static __device__ int epi_cols(int m) { return m; }
  static __device__ void epi_phase(float u1, float, int j, int m,
                                   int fft_order, float* c, float* s) {
    phase(u1, mode_value<float>(j, m, fft_order), c, s);
  }
  static int red_len(int m) { return m * j3_len(m); }
  static int cols(int m) { return (m + 31) / 32 * 32; }
  static __device__ float2 coef(const float2* __restrict__ f, int b, int j,
                                int k, int m, int) {
    const int st = k / T2C_KS;
    const int j2 = st % m, j3 = st / m * T2C_KS + k % T2C_KS;
    return j < m && j3 < m ? f[(((size_t)b * m + j) * m + j2) * m + j3]
                           : make_float2(0.f, 0.f);
  }
};

// ---------------------------------------------------------------------------
// type-2 in float64 on the FP64 tensor cores: tc_type2_f64.cuh's kernel on
// the d=3 problem, Type2Grid3D's GEMM over the pairs (j2, j3) with columns
// (b, j1) and the sum over j1 in its epilogue, but the modes j3 padded to
// whole k-steps of 8, not to a stage of 32 (mtot 21 -> 24, 1.14x, where
// float32 pads 1.52x): k-step ks is (j2, s) = (ks / n3, ks % n3), n3 =
// ceil(mtot / 8), its indices j3 = 8 s + r.  A's entry at (j2, j3) is
// (e2(j2) e(u3, 8 s - half)) e(u3, r): the k-step's factor is made once a
// chunk of k-steps, from e(u3, 8 s - half) and e2(j2) = e(u2, 8 (j2 / 8) -
// half) e(u2, j2 % 8), made once a chunk for each j2 it reaches (Extra),
// then one complex product an entry.  The reduction is long (mtot n3
// k-steps: 63 at mtot 21, 8 160 at 255), so A is made again for every
// column tile; for few points the launch splits its chunks over a grid axis
// (kSplitK; ops/cuda_nufft.py type2_3d_geometry at float64).
// ---------------------------------------------------------------------------
struct Type2F64Grid3D {
  struct X {
    double x, y, z;
  };
  static constexpr int kCoords = 3, kRedCoord = 2;
  // 4 k-steps of A at once: with the third axis's factors and e2's values
  // 110 KB of shared memory a block, two blocks an SM
  static constexpr int kChunk = 4;
  static constexpr bool kSplitK = true;
  static constexpr bool kSplitCols = false, kCarry = false;
  static bool split_ok(int, int split) { return split == 1; }
  static __host__ __device__ int epi_cols(int m, int) { return m; }
  static __device__ int epi_base(int m) { return -((m - 1) / 2); }
  struct Extra {
    double2 e2[T2D_P][kChunk];   // e2(j2) of the chunk's j2, the first on
  };
  static __device__ double coord(const X& p, int c) {
    return c == 0 ? p.x : c == 1 ? p.y : p.z;
  }
  static __host__ __device__ int red_steps(int m, int) {
    return m * ((m + 7) / 8);
  }
  static __device__ bool red_ok(int ks, int r, int m, int) {
    return 8 * (ks % ((m + 7) / 8)) + r < m;
  }
  // the factors e2(j2) e(u3, 8 s - half) of k-steps ks0 .. ks0 + kn - 1:
  // e(u3, 8 s - half) and each j2's e2 (nd of them), then their products
  template <class S>
  static __device__ void chunk_factors(S& sm, int ks0, int kn, int m, int,
                                       int tid) {
    const int half = (m - 1) / 2, n3 = (m + 7) / 8;
    const int j2a = ks0 / n3, nd = (ks0 + kn - 1) / n3 - j2a + 1;
    for (int e = tid; e < T2D_P * 2 * kChunk; e += T2D_THREADS) {
      const int p = e / (2 * kChunk), q = e % (2 * kChunk);
      double c, sn;
      if (q < kChunk) {
        if (q < kn) {
          phase(sm.u[2][p], (double)(8 * ((ks0 + q) % n3) - half), &c, &sn);
          sm.s2[p][q] = make_double2(c, sn);
        }
      } else if (q - kChunk < nd) {
        const int j2 = j2a + q - kChunk;
        phase(sm.u[1][p], (double)(8 * (j2 >> 3) - half), &c, &sn);
        sm.ex.e2[p][q - kChunk] =
            cmul(make_double2(c, sn), sm.r[1][p][j2 & 7]);
      }
    }
    __syncthreads();
    for (int e = tid; e < T2D_P * kChunk; e += T2D_THREADS) {
      const int p = e / kChunk, s = e % kChunk;
      if (s < kn)
        sm.s2[p][s] = cmul(sm.ex.e2[p][(ks0 + s) / n3 - j2a], sm.s2[p][s]);
    }
  }
  // F_b[j1, (j2, j3)] at reduction index k: k-step k / 8 = (j2, s), j3 =
  // 8 s + k % 8
  static __device__ long long coef_index(int b, int j, int k, int m, int,
                                         int fft_order) {
    const int n3 = (m + 7) / 8, ks = k >> 3;
    const int j2 = ks / n3, j3 = 8 * (ks % n3) + (k & 7);
    if (j3 >= m) return -1;
    return (((long long)b * m + t64_out(j, m, fft_order)) * m +
            t64_out(j2, m, fft_order)) * m + t64_out(j3, m, fft_order);
  }
};

}  // namespace

extern "C" {

int gpq_nufft2_3d_f32(const void* x, const void* f, float h, int n, int m,
                      int nb, int fft_order, void* out, void* stream) {
  return launch_nufft2(x, f, h, n, m, nb, fft_order, out, stream);
}

// float64 on the FP64 tensor cores, with the caller's geometry
// (ops/cuda_nufft.py type2_3d_geometry at float64: points a block, columns
// a tile, indices k a stage, splits of the chunks of k-steps); the scratch
// holds the split f and, for two splits or more, their partials
int gpq_nufft2_3d_f64(const void* x, const void* f, double h, int n, int m,
                      int nb, int fft_order, int points, int cols, int stage,
                      int splits, void* scratch, long long scratch_doubles,
                      void* out, void* stream) {
  return launch_type2_f64<Type2F64Grid3D>(x, f, h, n, m, nb, fft_order,
                                          points, cols, stage, 1, splits,
                                          scratch, scratch_doubles, out,
                                          stream);
}

// float32 on the tensor cores, with the caller's geometry (ops/cuda_nufft.py
// type2_3d_geometry: points a block, columns a tile (32 or 64: at 128 the
// stage buffers, T and the per-stage phase source's table pass the 227 KB
// of shared memory a block may take), modes a stage, splits of the
// stages); the scratch holds the split f and, for two splits or more,
// their partials
int gpq_nufft2_3d_tc_f32(const void* x, const void* f, float h, int n, int m,
                         int nb, int fft_order, int points, int cols,
                         int stage, int splits, void* scratch,
                         long long scratch_floats, void* out, void* stream) {
  return launch_type2_tc<Type2Grid3D, 5>(x, f, h, n, m, nb, fft_order,
                                         points, cols, stage, splits, scratch,
                                         scratch_floats, out, stream);
}

// float32 on the tensor cores, with the caller's geometry (ops/cuda_nufft.py
// type1_3d_geometry): one vector in groups of G = 1, a batch of G = 2
int gpq_nufft1_3d_tc_f32(const void* x, const void* v, float h, int n, int m,
                         int nb, int fft_order, int rows, int cols, int group,
                         int acc, int run, int chunk, void* partial,
                         void* out, void* stream) {
  if (group == 1)
    return launch_type1_tc<Type1Grid3D, 1>(x, v, h, n, m, nb, fft_order,
                                           rows, cols, group, acc, run,
                                           chunk, partial, out, stream);
  return launch_type1_tc<Type1Grid3D, 2>(x, v, h, n, m, nb, fft_order, rows,
                                         cols, group, acc, run, chunk,
                                         partial, out, stream);
}

// float32 on the tensor cores for the wide grids (tc_type1_wide.cuh), with
// the caller's geometry (ops/cuda_nufft.py type1_3d_wide_geometry: rows,
// cols, points a register sum, a run, a group); one group of points writes
// the output itself (the partial is then unused)
int gpq_nufft1_3d_wide_f32(const void* x, const void* v, float h, int n,
                           int m, int nb, int fft_order, int rows, int cols,
                           int acc, int run, int chunk, void* partial,
                           void* out, void* stream) {
  return launch_type1_wide(x, v, h, n, m, nb, fft_order, rows, cols, acc,
                           run, chunk, partial, out, stream);
}

// float64 on the FP64 tensor cores, with the caller's geometry
// (ops/cuda_nufft.py type1_3d_geometry at float64): one vector in groups
// of G = 1, a batch of G = 2; the partial may be the output where the
// points make one group
int gpq_nufft1_3d_f64(const void* x, const void* v, double h, int n, int m,
                      int nb, int fft_order, int rows, int cols, int group,
                      int split, int run, int chunk, void* partial,
                      void* out, void* stream) {
  if (group == 1)
    return launch_type1_f64<Type1F64Grid3D, 1>(x, v, h, n, m, nb, fft_order,
                                               rows, cols, group, split, run,
                                               chunk, partial, out, stream);
  return launch_type1_f64<Type1F64Grid3D, 2>(x, v, h, n, m, nb, fft_order,
                                             rows, cols, group, split, run,
                                             chunk, partial, out, stream);
}

}  // extern "C"
