// Fused d=2 NUFFT kernels for Hopper (sm_90a), written by hand.
//
//   nufft2_2d (type-2, uniform -> points) replaces pallas_nufft2_2d and its
//   mode-tiled variant _pallas_nufft2_2d_tiled (gpquad/ops/pallas_nufft.py):
//       out[n] = sum_jk f[j,k] e^{+2 pi i (c1(n,j) + c2(n,k))}
//   nufft1_2d (type-1, points -> uniform) replaces pallas_nufft1_2d and its
//   mode-tiled variant _pallas_nufft1_2d_tiled:
//       out[j,k] = sum_n v_n e^{-2 pi i (c1(n,j) + c2(n,k))}
//
// c_t(n,j) is the phase in cycles of point n along dimension t at mode k_j,
// made on the fly as nufft_common.cuh describes.
//
// Nothing of size N x mtot is ever written to device memory: each kernel
// reads the points once and the mode block once.
//
// What bounds them on an H100: at the slice's shapes both kernels do
// ~8 mtot^2 flops per point of complex multiply-adds against ~16 bytes of
// point data, so they are bound by operations, not by bytes.
//  - type-2: three paths, which ops/cuda_nufft.py picks from the shape
//    (type2_2d_geometry for the batch, type2_2d_single_geometry for one
//    vector) and passes to the launch with its geometry:
//     - one thread per point on the CUDA cores (nufft2_2d_kernel): the
//       point's mode-2 phases for a tile of TK modes live in registers, the
//       f tile (TJ x TK) is staged in shared memory and read as a broadcast.
//       Modes are tiled, so any odd mtot works.  Narrow grids (the
//       headline's mtot 29), and float64 and the float32 batch below mtot
//       64 with many points;
//     - float32 from mtot 64 with many points, on the tensor cores
//       (nufft2_2d_batched_tc_kernel): a GEMM over the modes k with a
//       3xTF32 split, the sum over j in its epilogue; the single type-2
//       takes it at B = 1 (each output still has one owner);
//     - one vector, few points, three slabs of 16 modes j or more
//       (nufft2_2d_split_kernel): a grid axis over the slabs, so that the
//       card gets enough blocks, each thread keeping its slab's sums over k
//       in registers; launch_reduce adds the slabs' partials in slab
//       order.
//  - type-1, float32: a GEMM over the points on the tensor cores with a
//    3xTF32 split (tc_type1.cuh's kernel on Type1Grid2D below): 64 x 128
//    output tiles, the points in a fixed number of groups, each group's sum
//    taken in stages (mma accumulators), runs (shared memory) and a total
//    (the group's partial); a second pass adds the groups' partials in
//    group order.  No atomics: the result is deterministic.
//  - type-1, float64 (the oracle and the high-precision runs): the CUDA-core
//    design, a reduction over 2048-point chunks across blocks.  Stage 1:
//    each block owns a 16 x 16 tile of outputs and one chunk, stages v*E1
//    and E2 for sub-tiles of P points in shared memory, and writes its
//    partial sum.  Stage 2 adds the partials of all chunks in chunk order.
//
// The batched pair serves B vectors against the same points in one launch,
// the hyper-gradient's probe batches:
//   nufft2_2d_batched replaces pallas_nufft2_2d_batched: f (B, m, m) -> (B, N)
//   nufft1_2d_batched replaces pallas_nufft1_2d_batched: v (B, N) -> (B, m, m)
// Each kernel template has the batch group size G as a parameter; the single
// kernels are its G = 1 instances (the single type-2 on the CUDA cores, the
// float64 type-1).  A point's phases are made once per
// group and reused for every vector of the group; the products are done B
// times.  The batch runs in groups of a fixed size (a grid axis over
// groups), so the per-thread accumulators are a fixed number of registers
// whatever B is:
//  - type-2: the f tiles of the group's G vectors are staged together in
//    shared memory, and each e1 phase is made once and applied to all G.
//  - type-1 in float32: a group of 2 vectors takes the output tile's rows
//    (32 modes j each) and shares its e2 tile.
//  - type-1 in float64: e1 and e2 for a sub-tile of points are staged once
//    in shared memory with the group's values; each thread forms e1*e2 for
//    its output once per point and adds v_b * (e1*e2) for every b of the
//    group (at G = 1 v is folded into the staged e1 instead).  The partials
//    are (chunk, b, j, k) and the same chunk-order reduction adds them.
//
// The type-2 kernels are templated on the scalar type: float is the main
// path, and double tensors run a double instance of the same code.
//
// C interface (bound with ctypes): pointers and the stream are void*, each
// function returns cudaGetLastError() after its launches.

#include "tc_type1.cuh"

namespace {

// ---------------------------------------------------------------------------
// type-2: out[b, n] = sum_j e1(n,j) sum_k f[b,j,k] e2(n,k),  e = e^{+2 pi i c}
// Block = THREADS points x one group of up to G batch elements (grid axis y).
// The single kernel is the G = 1 instance (nb = 1).
// ---------------------------------------------------------------------------
template <typename T, int THREADS, int TJ, int TK, int G>
__global__ void __launch_bounds__(THREADS)
nufft2_2d_kernel(const v2_t<T>* __restrict__ x, const v2_t<T>* __restrict__ f,
                 T h, int n, int m, int nb, int fft_order,
                 v2_t<T>* __restrict__ out) {
  __shared__ v2_t<T> ftile[G][TJ][TK];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int b0 = blockIdx.y * G;
  // live batch elements of this group; a constant 1 for the single kernel,
  // so that its products and phases share one block the compiler schedules
  const int gn = G == 1 ? 1 : min(G, nb - b0);
  const bool live = i < n;
  const size_t mm = (size_t)m * m;
  T u1 = 0, u2 = 0;
  if (live) {
    v2_t<T> xi = x[i];
    u1 = torus(xi.x, h);
    u2 = torus(xi.y, h);
  }
  T acc_re[G], acc_im[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    acc_re[g] = 0;
    acc_im[g] = 0;
  }
  for (int k0 = 0; k0 < m; k0 += TK) {
    T c2[TK], s2[TK];
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      if (k0 + kk < m) {
        phase(u2, mode_value<T>(k0 + kk, m, fft_order), &c2[kk], &s2[kk]);
      } else {
        c2[kk] = 0;
        s2[kk] = 0;
      }
    }
    for (int j0 = 0; j0 < m; j0 += TJ) {
      __syncthreads();
      for (int e = threadIdx.x; e < G * TJ * TK; e += THREADS) {
        const int g = e / (TJ * TK), r = e % (TJ * TK);
        const int jj = r / TK, kk = r % TK;
        const int j = j0 + jj, k = k0 + kk;
        v2_t<T> val;
        val.x = 0;
        val.y = 0;
        if (g < gn && j < m && k < m) val = f[(b0 + g) * mm + (size_t)j * m + k];
        ftile[g][jj][kk] = val;
      }
      __syncthreads();
      const int jn = min(TJ, m - j0);
      for (int jj = 0; jj < jn; ++jj) {
        T c1, s1;
        phase(u1, mode_value<T>(j0 + jj, m, fft_order), &c1, &s1);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < gn) {   // uniform over the block
            T tr = 0, ti = 0;
#pragma unroll
            for (int kk = 0; kk < TK; ++kk) {
              const v2_t<T> a = ftile[g][jj][kk];
              tr = fma(a.x, c2[kk], fma(-a.y, s2[kk], tr));
              ti = fma(a.x, s2[kk], fma(a.y, c2[kk], ti));
            }
            acc_re[g] = fma(c1, tr, fma(-s1, ti, acc_re[g]));
            acc_im[g] = fma(c1, ti, fma(s1, tr, acc_im[g]));
          }
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < gn) {
        v2_t<T> o;
        o.x = acc_re[g];
        o.y = acc_im[g];
        out[(size_t)(b0 + g) * n + i] = o;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// single type-2 with a mode split, for few points on a wide grid:
//   partial[s, n] = sum_{j in slab s} e1(n,j) sum_k f[j,k] e2(n,k)
// Block = THREADS points x one slab of TJ modes j (grid axis y), the axis
// the TPU's _pallas_nufft2_2d_tiled splits (pallas_nufft.py:381), so that
// a call with few points still puts enough blocks on the card; the per-point
// kernel above gives 16 blocks at n = 1 000.  Each thread keeps the slab's
// TJ sums T_j = sum_k f[j,k] e2(n,k) in registers: per mode k one e2 phase,
// then TJ independent complex multiply-adds against the staged f tile (read
// as a broadcast); after the last k tile e1 is made once per (point, j) and
// the slab's sum taken in j order from zero.  launch_reduce adds the slabs'
// partials in slab order: no atomics, the same bits on every launch.
// ---------------------------------------------------------------------------
template <typename T, int THREADS, int TJ, int TK>
__global__ void __launch_bounds__(THREADS)
nufft2_2d_split_kernel(const v2_t<T>* __restrict__ x,
                       const v2_t<T>* __restrict__ f, T h, int n, int m,
                       int fft_order, v2_t<T>* __restrict__ partial) {
  __shared__ v2_t<T> ftile[TJ][TK];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int j0 = blockIdx.y * TJ;
  const int jn = min(TJ, m - j0);
  const bool live = i < n;
  T u1 = 0, u2 = 0;
  if (live) {
    v2_t<T> xi = x[i];
    u1 = torus(xi.x, h);
    u2 = torus(xi.y, h);
  }
  T tr[TJ], ti[TJ];
#pragma unroll
  for (int jj = 0; jj < TJ; ++jj) {
    tr[jj] = 0;
    ti[jj] = 0;
  }
  for (int k0 = 0; k0 < m; k0 += TK) {
    __syncthreads();
    for (int e = threadIdx.x; e < TJ * TK; e += THREADS) {
      const int jj = e / TK, kk = e % TK;
      v2_t<T> val;
      val.x = 0;
      val.y = 0;
      if (jj < jn && k0 + kk < m) val = f[(size_t)(j0 + jj) * m + k0 + kk];
      ftile[jj][kk] = val;
    }
    __syncthreads();
    const int kn = min(TK, m - k0);
    for (int kk = 0; kk < kn; ++kk) {
      T c2, s2;
      phase(u2, mode_value<T>(k0 + kk, m, fft_order), &c2, &s2);
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
        const v2_t<T> a = ftile[jj][kk];
        tr[jj] = fma(a.x, c2, fma(-a.y, s2, tr[jj]));
        ti[jj] = fma(a.x, s2, fma(a.y, c2, ti[jj]));
      }
    }
  }
  T acc_re = 0, acc_im = 0;
#pragma unroll
  for (int jj = 0; jj < TJ; ++jj) {
    if (jj < jn) {
      T c1, s1;
      phase(u1, mode_value<T>(j0 + jj, m, fft_order), &c1, &s1);
      acc_re = fma(c1, tr[jj], fma(-s1, ti[jj], acc_re));
      acc_im = fma(c1, ti[jj], fma(s1, tr[jj], acc_im));
    }
  }
  if (live) {
    v2_t<T> o;
    o.x = acc_re;
    o.y = acc_im;
    partial[(size_t)blockIdx.y * n + i] = o;
  }
}

// ---------------------------------------------------------------------------
// type-1 stage 1: partial[c, b, j, k] = sum_{n in chunk c} v[b, n] e1(n,j)
// e2(n,k), e = e^{-2 pi i c}.  Block = one 16 x 16 output tile, one chunk of
// points (grid axis y), one group of up to G batch elements (grid axis z).
// At G = 1 (the single kernel) the value is folded into the staged e1
// (v * e1), so each point and output costs one complex multiply-add; a group
// of G > 1 stages e1 alone, forms e1 * e2 once per point and output, and adds
// v_b * (e1 * e2) for every b of the group.
// ---------------------------------------------------------------------------
constexpr int T1_TJ = 16;
constexpr int T1_TK = 16;
constexpr int T1_THREADS = T1_TJ * T1_TK;

template <typename T, int P, int G>
__global__ void __launch_bounds__(T1_THREADS)
nufft1_2d_partial_kernel(const v2_t<T>* __restrict__ x,
                         const v2_t<T>* __restrict__ v, T h, int n, int m,
                         int nb, int fft_order, int chunk,
                         v2_t<T>* __restrict__ partial) {
  __shared__ T su1[P], su2[P];
  __shared__ v2_t<T> sv[G][P];
  __shared__ v2_t<T> e1[P][T1_TJ];   // e1(p, j), times v_p when G = 1
  __shared__ v2_t<T> e2[P][T1_TK];   // e2(p, k)
  const int ntk = (m + T1_TK - 1) / T1_TK;
  const int j0 = (blockIdx.x / ntk) * T1_TJ;
  const int k0 = (blockIdx.x % ntk) * T1_TK;
  const int jj = threadIdx.x / T1_TK, kk = threadIdx.x % T1_TK;
  const int b0 = blockIdx.z * G;
  const int gn = G == 1 ? 1 : min(G, nb - b0);
  const int p_begin = blockIdx.y * chunk;
  const int p_end = min(n, p_begin + chunk);
  T acc_re[G], acc_im[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    acc_re[g] = 0;
    acc_im[g] = 0;
  }
  for (int p0 = p_begin; p0 < p_end; p0 += P) {
    const int pn = min(P, p_end - p0);
    __syncthreads();
    for (int q = threadIdx.x; q < pn; q += T1_THREADS) {
      const v2_t<T> xq = x[p0 + q];
      su1[q] = torus(xq.x, h);
      su2[q] = torus(xq.y, h);
    }
    for (int e = threadIdx.x; e < G * P; e += T1_THREADS) {
      const int g = e / P, q = e % P;
      v2_t<T> val;
      val.x = 0;
      val.y = 0;
      if (g < gn && q < pn) val = v[(size_t)(b0 + g) * n + p0 + q];
      sv[g][q] = val;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < pn * T1_TJ; e += T1_THREADS) {
      const int q = e / T1_TJ, a = e % T1_TJ;
      v2_t<T> w;
      w.x = 0;
      w.y = 0;
      if (j0 + a < m) {
        T c, s;
        phase(su1[q], mode_value<T>(j0 + a, m, fft_order), &c, &s);
        if constexpr (G == 1) {
          const v2_t<T> vq = sv[0][q];
          // (c - i s)(vr + i vi)
          w.x = fma(c, vq.x, s * vq.y);
          w.y = fma(c, vq.y, -s * vq.x);
        } else {
          w.x = c;
          w.y = -s;
        }
      }
      e1[q][a] = w;
    }
    for (int e = threadIdx.x; e < pn * T1_TK; e += T1_THREADS) {
      const int q = e / T1_TK, b = e % T1_TK;
      v2_t<T> w;
      w.x = 0;
      w.y = 0;
      if (k0 + b < m) {
        T c, s;
        phase(su2[q], mode_value<T>(k0 + b, m, fft_order), &c, &s);
        w.x = c;
        w.y = -s;
      }
      e2[q][b] = w;
    }
    __syncthreads();
    for (int q = 0; q < pn; ++q) {
      const v2_t<T> a = e1[q][jj];
      const v2_t<T> b = e2[q][kk];
      if constexpr (G == 1) {
        acc_re[0] = fma(a.x, b.x, fma(-a.y, b.y, acc_re[0]));
        acc_im[0] = fma(a.x, b.y, fma(a.y, b.x, acc_im[0]));
      } else {
        const T er = fma(a.x, b.x, -a.y * b.y);
        const T ei = fma(a.x, b.y, a.y * b.x);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < gn) {   // uniform over the block
            const v2_t<T> vq = sv[g][q];
            acc_re[g] = fma(vq.x, er, fma(-vq.y, ei, acc_re[g]));
            acc_im[g] = fma(vq.x, ei, fma(vq.y, er, acc_im[g]));
          }
        }
      }
    }
  }
  if (j0 + jj < m && k0 + kk < m) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < gn) {
        v2_t<T> o;
        o.x = acc_re[g];
        o.y = acc_im[g];
        partial[(((size_t)blockIdx.y * nb + b0 + g) * m + (j0 + jj)) * m
                + (k0 + kk)] = o;
      }
    }
  }
}


// ---------------------------------------------------------------------------
// type-1 in float32 on the tensor cores: tc_type1.cuh's kernel on the d=2
// problem, rows the modes j of the first axis (e1 from x1), columns the
// modes k of the second (e2 from x2), output (j, k) of the mtot x mtot grid;
// the phases from the torus coordinates as the other d=2 kernels make them.
// ---------------------------------------------------------------------------
struct Type1Grid2D {
  using X = float2;
  using Acc = float;
  static __device__ void point(X xp, float h, float* a, float* b) {
    *a = torus(xp.x, h);
    *b = torus(xp.y, h);
  }
  static __device__ void row_phase(float a, float, float k, float* c,
                                   float* s) {
    phase(a, k, c, s);
  }
  static __device__ void col_phase(float, float b, float k, float* c,
                                   float* s) {
    phase(b, k, c, s);
  }
  template <int TJ>
  static __device__ float row_mode(int j, int m, int fft_order, bool* ok) {
    *ok = j < m;
    return *ok ? mode_value<float>(j, m, fft_order) : 0.f;
  }
  template <int TJ>
  static __device__ float col_mode(int k, int m, int fft_order, bool* ok) {
    return row_mode<TJ>(k, m, fft_order, ok);
  }
  template <int TJ>
  static __host__ __device__ int rows(int m) { return m; }
  template <int TJ>
  static __host__ __device__ int cols(int m) { return m; }
  static __host__ __device__ long long outputs(int m) {
    return (long long)m * m;
  }
  template <int TJ>
  static __device__ long long out_index(int j, int k, int m, int) {
    return j < m && k < m ? (long long)j * m + k : -1;
  }
};

// ---------------------------------------------------------------------------
// batched type-2 in float32 on the tensor cores.  It replaces
// pallas_nufft2_2d_batched (gpquad/ops/pallas_nufft.py:838), whose kernel is
// itself a matrix product (_type2_kernel_b, :809-833: T = F E2^T at HIGHEST
// precision, then sum_j e1 T).  Here, for the block's P points:
//   T[p, (b, j)] = sum_k e2(p, k) f_b[j, k]        a GEMM over the modes k,
//   out[b, p]    = sum_j e1(p, j) T[p, (b, j)]     in its epilogue,
// e = e^{+2 pi i c}, complex, as four real products:
//   T_re = C2 Fr + S2 (-Fi),   T_im = C2 Fi + S2 Fr   (C2, S2: cos, sin of e2).
// Each real operand is split into big and small tf32 values (split3), each
// real product taken as small*big + big*small + big*big on mma.sync
// m16n8k8, as in the type-1 (tc_type1.cuh).
//
// Operands:
//  - A = E2 (points x modes) is made on chip and never written to device
//    memory: per stage of T2C_KS modes, each thread makes whole A fragments
//    (t2c_make_quad: the phases of points g, g + 8 at modes t, t + 4, from
//    nufft_common.cuh with the rounding of t = x h the other d=2 kernels
//    carry) and stores them split, in fragment order, into shared memory,
//    so that a fragment is one 16-byte load and store (a row-major stage
//    cost four register moves per mma).  E2 for all modes does not fit
//    there (P x mtot x 16 bytes), so it is made again for every column
//    tile.
//  - B = F (modes x columns) is split once per call by
//    nufft2_split_kernel into a scratch of big and small planes, laid out
//    so that a stage of a column tile is contiguous (cp.async copies it) and
//    a thread's fragment pair and both parts are one 16-byte load.  The
//    columns are (b, j), each vector's padded to mq = a multiple of
//    T2C_CHUNK; at B 10 and mtot 339 the scratch takes 20 MB, which stays
//    in the L2.
//
// Block: 512 threads, P = 128 points, walking every column tile of
// T2C_NT = 128 columns in order; 16 warps in an 8 x 2 grid of 16 x 64 warp
// tiles (one m-tile by eight n-tiles, 64 fp32 sums a thread).  A stage:
// start the copy of F's next stage into the other buffer (cp.async), make
// E2's, wait for this stage's F, multiply; one role, so the phases and the
// products of a block do not overlap.  scripts/time_type2_batched.py takes
// the kernel apart on the card: at scale (B 10, mtot 339) most of the time
// is the products, mma.sync TF32 reaches only part of the dense rate, and
// the phases and E2's stores take most of the rest.  Other shapes (384 or
// 256 threads, two blocks an SM, 64-column tiles, 4 x 4 warps, the next
// stage's E2 made between this stage's k-steps) were slower.
//
// The sum, in a fixed order and with no atomics:
//  - a k-step's 8 modes in the mma accumulators, one chain of six mma
//    started from zero (Hopper's tensor cores do not round their fp32 sums
//    to nearest; longer chains biased the f32 gradient, see tc_type1.cuh);
//  - the k-steps added in fp32 registers, giving T;
//  - the epilogue: T goes to shared memory; thread (p, q) adds
//    e1(p, j) T[p, (b, j)] over the tile's q-th chunk of T2C_CHUNK columns
//    (one vector b, e1 made from the point's u1), in j order, from zero;
//  - thread p adds the chunks into out[b, p] in column order (the first
//    chunk of a vector stores): each output has one owner, so the result
//    is the same bit for bit on every launch.
//
// Bound: 3 x 8 flops per point, mode k and column on the tensor cores
// (495 TFLOP/s dense TF32); the phases (e2 once per column tile, e1 once
// per column) and the epilogue on the CUDA cores; F's scratch read from the
// L2 once per block (P = 128: ~144 GB at scale, B 10).
// ---------------------------------------------------------------------------
constexpr int T2C_THREADS = 512;
constexpr int T2C_P = 128;         // points a block
constexpr int T2C_NT = 128;        // columns (b, j) a column tile
constexpr int T2C_KS = 32;         // modes k a stage
constexpr int T2C_CHUNK = 32;      // columns of an epilogue sum
constexpr int T2C_WM = 8;          // warps along the points
constexpr int T2C_TS = T2C_NT + 1; // T's row stride (float2): odd, so a
                                   // warp's 32 points read 32 banks
static_assert(T2C_KS == T2C_CHUNK,
              "the modes k are padded to mq as the columns j are");
static_assert(T2C_THREADS / T2C_P == T2C_NT / T2C_CHUNK &&
                  T2C_P / 16 * (T2C_KS / 8) * 32 % T2C_THREADS == 0,
              "one epilogue thread a point and chunk; whole quads of E2 a "
              "thread");

struct T2cStage {
  // E2 in fragment order: [k-step][cos, sin][big, small][m-tile][lane][reg],
  // so that a thread's A fragment is one 16-byte load
  unsigned a[T2C_KS / 8][2][2][T2C_P / 16][32][4];
  float b[2][T2C_KS / 8][2][T2C_NT][16];   // F, two buffers:
                                           // [k-step][Re, Im][column]
};

struct T2cSmem {
  union {
    T2cStage st;
    float2 t[T2C_P][T2C_TS];            // the column tile's T, epilogue
  };
  float2 red[T2C_NT / T2C_CHUNK][T2C_P];  // the chunks' sums
  float u2[T2C_P];                      // the points' t = x h on the torus
};

// Where mode kk (0-7) of a k-step and part (0 big, 1 small) sit in F's
// group of 16 floats: a thread's fragment pair (kk = t, t + 4) and both
// parts are the float4 at 4 t.
__device__ __forceinline__ int t2c_pos(int kk, int part) {
  return (kk & 3) * 4 + part * 2 + (kk >> 2);
}

// One A fragment (4 tf32 values) from shared memory
__device__ __forceinline__ void t2c_afrag(const unsigned* src,
                                          unsigned (&o)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy F's stage at modes k0.. of the column tile c0.. (per k-step and part
// T2C_NT columns x 16 floats, contiguous in fs) into buf, as one cp.async
// group
__device__ __forceinline__ void t2c_load_f(float (*buf)[2][T2C_NT][16],
                                           const float4* __restrict__ fs,
                                           int ncp, int c0, int k0, int tid) {
  constexpr int ROW4 = T2C_NT * 4;   // float4 a (k-step, part)
#pragma unroll
  for (int e = tid; e < T2C_KS / 8 * 2 * ROW4; e += T2C_THREADS) {
    const int r = e / ROW4, q4 = e % ROW4;
    cp_async16(reinterpret_cast<float4*>(&buf[r >> 1][r & 1][0][0]) + q4,
               fs + ((size_t)(k0 / 8 * 2 + r) * ncp + c0) * 4 + q4);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// F (B, m, m) complex -> the split scratch fs[k-step][Re, Im][column][16],
// column (b, j) at b mq + j, zero past m, past B and in the ncp - B mq pad
// columns.  One thread per (mode k, column), k fastest (coalesced reads).
__global__ void nufft2_split_kernel(const float2* __restrict__ f, int m,
                                    int nb, int mq, int ncp,
                                    float* __restrict__ fs) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)mq * ncp) return;
  const int k = (int)(idx % mq), col = (int)(idx / mq);
  const int b = col / mq, j = col % mq;
  float2 v = make_float2(0.f, 0.f);
  if (b < nb && j < m && k < m) v = f[((size_t)b * m + j) * m + k];
  unsigned rb, rs, ib, is;
  split3(v.x, &rb, &rs);
  split3(v.y, &ib, &is);
  const int ks = k >> 3, kk = k & 7;
  float* re = fs + ((size_t)(ks * 2) * ncp + col) * 16;
  float* im = fs + ((size_t)(ks * 2 + 1) * ncp + col) * 16;
  re[t2c_pos(kk, 0)] = __uint_as_float(rb);
  re[t2c_pos(kk, 1)] = __uint_as_float(rs);
  im[t2c_pos(kk, 0)] = __uint_as_float(ib);
  im[t2c_pos(kk, 1)] = __uint_as_float(is);
}

// E2's A-fragment quad q of the stage at modes k0..: lane q % 32 = 4 g + t
// of m-tile (q / 32) % (P / 16) and k-step q / (32 P / 16); registers a0
// (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4) of cos and sin, each
// split; zero past m
__device__ __forceinline__ void t2c_make_quad(T2cSmem& sm, int q, int k0,
                                              int m, int fft_order) {
  constexpr int MT = T2C_P / 16;
  const int lane = q & 31, mt = (q >> 5) % MT, ks = (q >> 5) / MT;
  const int p = mt * 16 + (lane >> 2), k = k0 + ks * 8 + (lane & 3);
  const float u[2] = {sm.u2[p], sm.u2[p + 8]};
  float c[4], s[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kr = k + (r >> 1) * 4;
    const float kv = mode_value<float>(kr, m, fft_order);
    c[r] = 0.f;
    s[r] = 0.f;
    if (kr < m) phase(u[r & 1], kv, &c[r], &s[r]);
  }
  uint4 cb, cs, sb, ss;
  split3(c[0], &cb.x, &cs.x);
  split3(c[1], &cb.y, &cs.y);
  split3(c[2], &cb.z, &cs.z);
  split3(c[3], &cb.w, &cs.w);
  split3(s[0], &sb.x, &ss.x);
  split3(s[1], &sb.y, &ss.y);
  split3(s[2], &sb.z, &ss.z);
  split3(s[3], &sb.w, &ss.w);
  *reinterpret_cast<uint4*>(sm.st.a[ks][0][0][mt][lane]) = cb;
  *reinterpret_cast<uint4*>(sm.st.a[ks][0][1][mt][lane]) = cs;
  *reinterpret_cast<uint4*>(sm.st.a[ks][1][0][mt][lane]) = sb;
  *reinterpret_cast<uint4*>(sm.st.a[ks][1][1][mt][lane]) = ss;
}

__global__ void __launch_bounds__(T2C_THREADS, 1)
nufft2_2d_batched_tc_kernel(const float2* __restrict__ x,
                            const float4* __restrict__ fs, float h, int n,
                            int m, int nb, int fft_order, int mq, int ncp,
                            float2* __restrict__ out) {
  extern __shared__ float4 t2c_smem[];
  T2cSmem& sm = *reinterpret_cast<T2cSmem*>(t2c_smem);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * T2C_P;
  const int ncols = nb * mq;
  // epilogue: point ep, chunk eq of the tile; u1 of the point in a
  // register
  const int ep = tid % T2C_P, eq = tid / T2C_P;
  float u1;
  {
    float2 xp = make_float2(0.f, 0.f);
    if (p0 + ep < n) xp = x[p0 + ep];
    u1 = torus(xp.x, h);
    if (tid < T2C_P) sm.u2[tid] = torus(xp.y, h);
  }
  // the products: WM x WN warps, warp tile (wr, wc) of MI m-tiles by NI
  // n-tiles, fragment row / column (gq, tq)
  constexpr int WM = T2C_WM, WN = T2C_THREADS / 32 / WM;
  constexpr int MI = T2C_P / WM / 16, NI = T2C_NT / WN / 8;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  static_assert(MI * WM * 16 == T2C_P && NI * WN * 8 == T2C_NT,
                "the warp grid covers the block's tile");
  const int wr = (warp / WN) * (MI * 16), wc = (warp % WN) * (NI * 8);

  for (int c0 = 0; c0 < ncols; c0 += T2C_NT) {
    float acc[MI][NI][8];   // T: [m-tile][n-tile][re 4, im 4]
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int b = 0; b < NI; ++b)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][b][c] = 0.f;
    const int nst = mq / T2C_KS;
    __syncthreads();   // the buffers are free (the last tile's epilogue)
    t2c_load_f(sm.st.b[0], fs, ncp, c0, 0, tid);
    for (int st = 0; st < nst; ++st) {
      const int k0 = st * T2C_KS;
      // F's next stage into the other buffer, while this one is used
      if (st + 1 < nst)
        t2c_load_f(sm.st.b[(st + 1) & 1], fs, ncp, c0, k0 + T2C_KS, tid);
      // E2's stage, split: each thread makes whole A fragments, the
      // quads of lane (g, t) of an m-tile and k-step (points g and g + 8,
      // modes t and t + 4), one 16-byte store a part
#pragma unroll
      for (int q = tid; q < T2C_P / 16 * (T2C_KS / 8) * 32; q += T2C_THREADS)
        t2c_make_quad(sm, q, k0, m, fft_order);
      if (st + 1 < nst)
        cp_async_wait<1>();   // all but the next stage's copy
      else
        cp_async_wait<0>();
      __syncthreads();
      const float(*fb)[2][T2C_NT][16] = sm.st.b[st & 1];
#pragma unroll
      for (int ks = 0; ks < T2C_KS / 8; ++ks) {
        // A fragments of cos and sin: [m-tile][part][reg]
        unsigned ca[MI][2][4], sa[MI][2][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int mt = wr / 16 + mi;
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            t2c_afrag(sm.st.a[ks][0][part][mt][lane], ca[mi][part]);
            t2c_afrag(sm.st.a[ks][1][part][mt][lane], sa[mi][part]);
          }
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          // B fragments b0 (t, g), b1 (t+4, g): [part][reg]
          const int col = wc + ni * 8 + gq;
          const uint4 r4 =
              *reinterpret_cast<const uint4*>(&fb[ks][0][col][tq * 4]);
          const uint4 i4 =
              *reinterpret_cast<const uint4*>(&fb[ks][1][col][tq * 4]);
          const unsigned fr[2][2] = {{r4.x, r4.y}, {r4.z, r4.w}};
          const unsigned fi[2][2] = {{i4.x, i4.y}, {i4.z, i4.w}};
          float d[MI][8];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int c = 0; c < 8; ++c) d[mi][c] = 0.f;
          // small*big, big*small, big*big; Re += C Fr + S (-Fi),
          // Im += C Fi + S Fr: one chain of six mma a sum, from zero
#pragma unroll
          for (int pass = 0; pass < 3; ++pass) {
            const int pa = pass == 0 ? 1 : 0;     // A's part
            const int pb = pass == 1 ? 1 : 0;     // B's part
            const unsigned nfi[2] = {fi[pb][0] ^ 0x80000000u,
                                     fi[pb][1] ^ 0x80000000u};
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              mma_tf32(&d[mi][0], ca[mi][pa], fr[pb]);
              mma_tf32(&d[mi][4], ca[mi][pa], fi[pb]);
            }
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              mma_tf32(&d[mi][0], sa[mi][pa], nfi);
              mma_tf32(&d[mi][4], sa[mi][pa], fr[pb]);
            }
          }
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              acc[mi][ni][c] = __fadd_rn(acc[mi][ni][c], d[mi][c]);
        }
      }
      __syncthreads();   // E2's buffer and this F buffer are free again
    }
    // the epilogue: T to shared memory (C fragment c0 (g, 2t), c1 (g, 2t+1),
    // c2 (g+8, 2t), c3 (g+8, 2t+1))
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wr + mi * 16 + gq + (i >> 1) * 8;
          const int col = wc + ni * 8 + 2 * tq + (i & 1);
          sm.t[row][col] = make_float2(acc[mi][ni][i], acc[mi][ni][4 + i]);
        }
    __syncthreads();
    {
      // chunk eq: one vector's columns j0.. in j order, from zero
      const int cc = c0 + eq * T2C_CHUNK;
      const int b = cc / mq, j0 = cc % mq;
      float sr = 0.f, si = 0.f;
      if (b < nb) {
        const int jn = min(T2C_CHUNK, m - j0);
        for (int jj = 0; jj < jn; ++jj) {
          float c, s;
          phase(u1, mode_value<float>(j0 + jj, m, fft_order), &c, &s);
          const float2 tv = sm.t[ep][eq * T2C_CHUNK + jj];
          // (c + i s)(T_re + i T_im)
          sr = __fadd_rn(sr, fmaf(c, tv.x, -s * tv.y));
          si = __fadd_rn(si, fmaf(c, tv.y, s * tv.x));
        }
      }
      sm.red[eq][ep] = make_float2(sr, si);
    }
    __syncthreads();
    if (tid < T2C_P && p0 + tid < n) {
#pragma unroll
      for (int q = 0; q < T2C_NT / T2C_CHUNK; ++q) {
        const int cc = c0 + q * T2C_CHUNK;
        const int b = cc / mq;
        if (b >= nb) break;
        float2* o = out + (size_t)b * n + p0 + tid;
        float2 v = sm.red[q][tid];
        if (cc % mq != 0) {   // not the vector's first chunk: add
          const float2 prev = *o;
          v.x = __fadd_rn(prev.x, v.x);
          v.y = __fadd_rn(prev.y, v.y);
        }
        *o = v;
      }
    }
  }
}

// The single kernels are the G = 1 instances (the single type-2's CUDA-core
// path with 64 threads per block); a batch runs in groups of 4 (type-2, 128
// threads) or 8 (the float64 type-1) vectors, and the float32 type-1 on the
// tensor cores in groups of 2.
constexpr int T2_THREADS = 64;
constexpr int T2B_THREADS = 128;
constexpr int T2B_GROUP = 4;
constexpr int T1B_GROUP = 8;
constexpr int TCB_GROUP = 2;

template <typename T, int THREADS, int G>
int launch_nufft2(const void* x, const void* f, T h, int n, int m, int nb,
                  int fft_order, void* out, void* stream) {
  constexpr int TJ = 32;
  constexpr int TK = sizeof(T) == 4 ? 32 : 16;
  const dim3 grid((n + THREADS - 1) / THREADS, (nb + G - 1) / G);
  nufft2_2d_kernel<T, THREADS, TJ, TK, G>
      <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
          (const v2_t<T>*)x, (const v2_t<T>*)f, h, n, m, nb, fft_order,
          (v2_t<T>*)out);
  return (int)cudaGetLastError();
}

// The single type-2's mode split: the caller's geometry (modes j a slab,
// threads a block; ops/cuda_nufft.py type2_2d_single_geometry) checked
// against the one instance, then the ceil(m / rows) slabs' partials
// (slabs x n values in `partial`) added in slab order
constexpr int T2S_THREADS = 64;
constexpr int T2S_ROWS = 16;
constexpr int T2S_TK = 32;

template <typename T>
int launch_nufft2_split(const void* x, const void* f, T h, int n, int m,
                        int fft_order, int rows, int threads, void* partial,
                        void* out, void* stream) {
  if (rows != T2S_ROWS || threads != T2S_THREADS)
    return (int)cudaErrorInvalidValue;
  const int slabs = (m + T2S_ROWS - 1) / T2S_ROWS;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((n + T2S_THREADS - 1) / T2S_THREADS, slabs);
  nufft2_2d_split_kernel<T, T2S_THREADS, T2S_ROWS, T2S_TK>
      <<<grid, T2S_THREADS, 0, s>>>((const v2_t<T>*)x, (const v2_t<T>*)f, h,
                                    n, m, fft_order, (v2_t<T>*)partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_reduce<T>(partial, slabs, n, out, s);
}

template <typename T, int G>
int launch_nufft1(const void* x, const void* v, T h, int n, int m, int nb,
                  int fft_order, int chunk, void* partial, void* out,
                  void* stream) {
  constexpr int P = 64;     // the float64 instances; float32 takes the tc kernel
  const int ntj = (m + T1_TJ - 1) / T1_TJ;
  const int nchunk = (n + chunk - 1) / chunk;
  const dim3 grid(ntj * ntj, nchunk, (nb + G - 1) / G);
  cudaStream_t s = (cudaStream_t)stream;
  nufft1_2d_partial_kernel<T, P, G><<<grid, T1_THREADS, 0, s>>>(
      (const v2_t<T>*)x, (const v2_t<T>*)v, h, n, m, nb, fft_order, chunk,
      (v2_t<T>*)partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_reduce<T>(partial, nchunk, nb * m * m, out, s);
}

// float32 batched type-2 on the tensor cores: the caller's geometry (points
// a block, columns a tile, modes a stage; ops/cuda_nufft.py
// type2_2d_geometry) checked against the one instance, and the split F's
// scratch (scratch_floats floats) against what it must hold
int launch_nufft2_tc(const void* x, const void* f, float h, int n, int m,
                     int nb, int fft_order, int points, int cols, int stage,
                     void* scratch, long long scratch_floats, void* out,
                     void* stream) {
  if (points != T2C_P || cols != T2C_NT || stage != T2C_KS)
    return (int)cudaErrorInvalidValue;
  const int mq = (m + T2C_CHUNK - 1) / T2C_CHUNK * T2C_CHUNK;
  const long long ncp =
      ((long long)nb * mq + T2C_NT - 1) / T2C_NT * T2C_NT;
  if (ncp * mq >= (1LL << 31) || ncp * mq * 4 > scratch_floats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long cells = ncp * mq;
  nufft2_split_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, s>>>(
      (const float2*)f, m, nb, mq, (int)ncp, (float*)scratch);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  constexpr int smem = sizeof(T2cSmem);
  err = (int)cudaFuncSetAttribute(nufft2_2d_batched_tc_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err != 0) return err;
  nufft2_2d_batched_tc_kernel<<<(n + T2C_P - 1) / T2C_P, T2C_THREADS, smem,
                                s>>>(
      (const float2*)x, (const float4*)scratch, h, n, m, nb, fft_order, mq,
      (int)ncp, (float2*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gpq_nufft2_2d_f32(const void* x, const void* f, float h, int n, int m,
                      int fft_order, void* out, void* stream) {
  return launch_nufft2<float, T2_THREADS, 1>(x, f, h, n, m, 1, fft_order, out,
                                             stream);
}

int gpq_nufft2_2d_f64(const void* x, const void* f, double h, int n, int m,
                      int fft_order, void* out, void* stream) {
  return launch_nufft2<double, T2_THREADS, 1>(x, f, h, n, m, 1, fft_order, out,
                                              stream);
}

// the single type-2's mode split (ops/cuda_nufft.py
// type2_2d_single_geometry; its tensor-core path is
// gpq_nufft2_2d_batched_tc_f32 at B 1)
int gpq_nufft2_2d_split_f32(const void* x, const void* f, float h, int n,
                            int m, int fft_order, int rows, int threads,
                            void* partial, void* out, void* stream) {
  return launch_nufft2_split<float>(x, f, h, n, m, fft_order, rows, threads,
                                    partial, out, stream);
}

int gpq_nufft2_2d_split_f64(const void* x, const void* f, double h, int n,
                            int m, int fft_order, int rows, int threads,
                            void* partial, void* out, void* stream) {
  return launch_nufft2_split<double>(x, f, h, n, m, fft_order, rows, threads,
                                     partial, out, stream);
}

int gpq_nufft1_2d_f32(const void* x, const void* v, float h, int n, int m,
                      int fft_order, int rows, int cols, int group, int acc,
                      int run, int chunk, void* partial, void* out,
                      void* stream) {
  return launch_type1_tc<Type1Grid2D, 1>(x, v, h, n, m, 1, fft_order, rows,
                                         cols, group, acc, run, chunk,
                                         partial, out, stream);
}

int gpq_nufft1_2d_f64(const void* x, const void* v, double h, int n, int m,
                      int fft_order, int chunk, void* partial, void* out,
                      void* stream) {
  return launch_nufft1<double, 1>(x, v, h, n, m, 1, fft_order, chunk, partial, out,
                                  stream);
}

int gpq_nufft2_2d_batched_f32(const void* x, const void* f, float h, int n,
                              int m, int nb, int fft_order, void* out,
                              void* stream) {
  return launch_nufft2<float, T2B_THREADS, T2B_GROUP>(x, f, h, n, m, nb, fft_order,
                                                      out, stream);
}

int gpq_nufft2_2d_batched_tc_f32(const void* x, const void* f, float h,
                                 int n, int m, int nb, int fft_order,
                                 int points, int cols, int stage,
                                 void* scratch, long long scratch_floats,
                                 void* out, void* stream) {
  return launch_nufft2_tc(x, f, h, n, m, nb, fft_order, points, cols, stage,
                          scratch, scratch_floats, out, stream);
}

int gpq_nufft2_2d_batched_f64(const void* x, const void* f, double h, int n,
                              int m, int nb, int fft_order, void* out,
                              void* stream) {
  return launch_nufft2<double, T2B_THREADS, T2B_GROUP>(x, f, h, n, m, nb, fft_order,
                                                       out, stream);
}

int gpq_nufft1_2d_batched_f32(const void* x, const void* v, float h, int n,
                              int m, int nb, int fft_order, int rows,
                              int cols, int group, int acc, int run,
                              int chunk, void* partial, void* out,
                              void* stream) {
  return launch_type1_tc<Type1Grid2D, TCB_GROUP>(x, v, h, n, m, nb,
                                                 fft_order, rows, cols, group,
                                                 acc, run, chunk, partial,
                                                 out, stream);
}

int gpq_nufft1_2d_batched_f64(const void* x, const void* v, double h, int n,
                              int m, int nb, int fft_order, int chunk,
                              void* partial, void* out, void* stream) {
  return launch_nufft1<double, T1B_GROUP>(x, v, h, n, m, nb, fft_order, chunk,
                                          partial, out, stream);
}

}  // extern "C"
