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
//  - type-2: four paths, which ops/cuda_nufft.py picks from the shape
//    (type2_2d_geometry for the batch, type2_2d_single_geometry for one
//    vector) and passes to the launch with its geometry:
//     - one thread per point on the CUDA cores (nufft2_2d_kernel): the
//       point's mode-2 phases for a tile of TK modes live in registers, the
//       f tile (TJ x TK) is staged in shared memory and read as a broadcast.
//       Modes are tiled, so any odd mtot works.  Narrow grids (the
//       headline's mtot 29) with many points, and the float32 batch below
//       mtot 64;
//     - float32 from mtot 64 with many points, on the tensor cores
//       (tc_type2.cuh's type2_tc_kernel on Type2Grid2D below): a GEMM over
//       the modes k with a 3xTF32 split, the sum over j in its epilogue;
//       the single type-2 takes it at B = 1 (each output still has one
//       owner);
//     - float64 on the FP64 tensor cores (tc_type2_f64.cuh's
//       type2_f64_kernel on Type2F64Grid2D below, DMMA m16n8k8): the same
//       GEMM and epilogue with no split, the mode index split so that a
//       point makes few phases; the float64 batch always, the single where
//       the table sends it;
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
//  - type-1, float64 (the oracle and the high-precision runs): a GEMM over
//    the points on the FP64 tensor cores (tc_type1_f64.cuh's kernel on
//    Type1F64Grid2D below, DMMA m16n8k8), the mode index split so that a
//    point makes few phases a tile, the points in a fixed number of groups,
//    a second pass adding the groups' partials in group order.
//
// The batched pair serves B vectors against the same points in one launch,
// the hyper-gradient's probe batches:
//   nufft2_2d_batched replaces pallas_nufft2_2d_batched: f (B, m, m) -> (B, N)
//   nufft1_2d_batched replaces pallas_nufft1_2d_batched: v (B, N) -> (B, m, m)
// Each kernel template has the batch group size G as a parameter; the single
// kernels are its G = 1 instances (the single type-2 on the CUDA cores, the
// type-1).  A point's phases are made once per
// group and reused for every vector of the group; the products are done B
// times.  The batch runs in groups of a fixed size (a grid axis over
// groups), so the per-thread accumulators are a fixed number of registers
// whatever B is:
//  - type-2 on the CUDA cores (float32 below mtot 64): the f tiles of the
//    group's G vectors are staged together in shared memory, and each e1
//    phase is made once and applied to all G; on the tensor cores a block
//    walks the B vectors' columns in tiles.
//  - type-1 in float32: a group of 2 vectors takes the output tile's rows
//    (32 modes j each) and shares its e2 tile.
//  - type-1 in float64: likewise, on the FP64 tensor cores.
//
// The CUDA-core type-2 kernels are templated on the scalar type: float is
// the main path, and the single type-2's double tensors run a double
// instance of the same code where the table keeps them off the FP64 tensor
// cores.
//
// C interface (bound with ctypes): pointers and the stream are void*, each
// function returns cudaGetLastError() after its launches.

#include "tc_type1_f64.cuh"
#include "tc_type2.cuh"
#include "tc_type2_f64.cuh"

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
// type-1 in float32 on the tensor cores: tc_type1.cuh's kernel on the d=2
// problem, rows the modes j of the first axis (e1 from x1), columns the
// modes k of the second (e2 from x2), output (j, k) of the mtot x mtot grid;
// the phases from the torus coordinates as the other d=2 kernels make them.
// ---------------------------------------------------------------------------
struct Type1Grid2D {
  using X = float2;
  using Acc = float;
  using Row = float;
  using Col = float;
  static constexpr int kTab = 0;
  // (no third coordinate: the phases do not read it)
  static __device__ void point(X xp, float h, float* a, float* b, float*) {
    *a = torus(xp.x, h);
    *b = torus(xp.y, h);
  }
  static __device__ void row_phase(float a, float, float, const float2*,
                                   float k, float* c, float* s) {
    phase(a, k, c, s);
  }
  static __device__ void col_phase(float, float b, float, const float2*,
                                   float k, float* c, float* s) {
    phase(b, k, c, s);
  }
  template <int TJ>
  static __device__ float row_mode(int j, int m, int fft_order, bool* ok) {
    *ok = j < m;
    return *ok ? mode_value<float>(j, m, fft_order) : 0.f;
  }
  template <int TJ, int COLS>
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
// type-1 in float64 on the FP64 tensor cores: tc_type1_f64.cuh's kernel on
// the d=2 problem, row j mode j - half of the first axis (e1 from x1),
// column k mode k - half of the second (e2 from x2), output (j, k) of the
// mtot x mtot grid; no outer index (inner passes every index) and no split
// ---------------------------------------------------------------------------
struct Type1F64Grid2D {
  using X = double2;
  static constexpr int kCoords = 2, kRowCoord = 0, kColCoord = 1;
  static constexpr bool kOuter = false;
  static constexpr bool kCarry = false;
  // the modes of the rows' and the columns' index 0 (of an outer value)
  static __device__ int row_base(int m, int) { return -((m - 1) / 2); }
  static __device__ int col_base(int m, int) { return -((m - 1) / 2); }
  template <int S1, int S2>
  static __host__ __device__ constexpr int max_factors() {
    return 2 * T64_K + S1 + S2;
  }
  template <int S1, int S2>
  static __host__ __device__ constexpr int fixed_factors() {
    return max_factors<S1, S2>();
  }
  static __device__ double coord(const X& p, int c) {
    return c == 0 ? p.x : p.y;
  }
  static __host__ __device__ int inner(int) { return 1 << 30; }
  static bool split_ok(int, int split) { return split == 1; }
  static __host__ __device__ int rows(int m, int) { return m; }
  static __host__ __device__ int cols(int m, int) { return m; }
  static __host__ __device__ long long outputs(int m) {
    return (long long)m * m;
  }
  static __device__ long long out_index(int j, int k, int m, int,
                                        int fft_order) {
    return j < m && k < m ? (long long)t64_out(j, m, fft_order) * m +
                                t64_out(k, m, fft_order)
                          : -1;
  }
};

// ---------------------------------------------------------------------------
// type-2 in float64 on the FP64 tensor cores: tc_type2_f64.cuh's kernel on
// the d=2 problem, batched and at B 1: the reduction runs over the modes k
// of the second axis in k-steps of 8 (A = e2 from x2: a k-step's factor
// e(u2, 8 s - half), its entries' e(u2, r)), the epilogue over the modes j
// of the first (e1 from x1); no split of the reduction
// ---------------------------------------------------------------------------
struct Type2F64Grid2D {
  using X = double2;
  static constexpr int kCoords = 2, kRedCoord = 1;
  static constexpr int kChunk = 6;   // 48 modes k: A kept a block to mtot 47
  static constexpr bool kSplitK = false;
  static constexpr bool kSplitCols = false, kCarry = false;
  static bool split_ok(int, int split) { return split == 1; }
  static __host__ __device__ int epi_cols(int m, int) { return m; }
  static __device__ int epi_base(int m) { return -((m - 1) / 2); }
  struct Extra {};
  static __device__ double coord(const X& p, int c) {
    return c == 0 ? p.x : p.y;
  }
  static __host__ __device__ int red_steps(int m, int) { return (m + 7) / 8; }
  static __device__ bool red_ok(int ks, int r, int m, int) {
    return 8 * ks + r < m;
  }
  template <class S>
  static __device__ void chunk_factors(S& sm, int ks0, int kn, int m, int,
                                       int tid) {
    const int half = (m - 1) / 2;
    for (int e = tid; e < T2D_P * kChunk; e += T2D_THREADS) {
      const int p = e / kChunk, s = e % kChunk;
      if (s < kn) {
        double c, sn;
        phase(sm.u[1][p], (double)(8 * (ks0 + s) - half), &c, &sn);
        sm.s2[p][s] = make_double2(c, sn);
      }
    }
  }
  static __device__ long long coef_index(int b, int j, int k, int m, int,
                                         int fft_order) {
    return k < m ? ((long long)b * m + t64_out(j, m, fft_order)) * m +
                       t64_out(k, m, fft_order)
                 : -1;
  }
};

// ---------------------------------------------------------------------------
// batched type-2 in float32 on the tensor cores: tc_type2.cuh's kernel on
// the d=2 problem.  It replaces pallas_nufft2_2d_batched
// (gpquad/ops/pallas_nufft.py:838), whose kernel is itself a matrix product
// (_type2_kernel_b, :809-833: T = F E2^T at HIGHEST precision, then
// sum_j e1 T): the reduction runs over the modes k of the second axis (eA =
// e2 from x2, phase() of the torus coordinate as the other d=2 kernels make
// it), the epilogue over the modes j of the first (eE = e1 from x1); both
// padded to a multiple of 32.
// ---------------------------------------------------------------------------
struct Type2Grid2D {
  using X = float2;
  static constexpr bool kWholeStages = true;   // red_len: multiples of 32
  static constexpr bool kStagePhases = false;
  static constexpr bool kSplitK = false;
  static __device__ void point(X xp, float h, float* a, float* b) {
    *a = torus(xp.x, h);
    *b = torus(xp.y, h);
  }
  static __device__ float red_mode(int k, int m, int fft_order, bool* ok) {
    *ok = k < m;
    return mode_value<float>(k, m, fft_order);
  }
  static __device__ void red_phase(float, float b, float kv, float* c,
                                   float* s) {
    phase(b, kv, c, s);
  }
  static __device__ int epi_cols(int m) { return m; }
  static __device__ void epi_phase(float a, float, int j, int m,
                                   int fft_order, float* c, float* s) {
    phase(a, mode_value<float>(j, m, fft_order), c, s);
  }
  static int red_len(int m) { return (m + 31) / 32 * 32; }
  static int cols(int m) { return red_len(m); }
  static __device__ float2 coef(const float2* __restrict__ f, int b, int j,
                                int k, int m, int) {
    return j < m && k < m ? f[((size_t)b * m + j) * m + k]
                          : make_float2(0.f, 0.f);
  }
};

// The single kernels are the G = 1 instances (the single type-2's CUDA-core
// path with 64 threads per block); a float32 batch on the CUDA cores runs in
// groups of 4 vectors (type-2, 128 threads), and the type-1 (float32 and
// float64) in groups of 2.
constexpr int T2_THREADS = 64;
constexpr int T2B_THREADS = 128;
constexpr int T2B_GROUP = 4;
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

// the float64 type-1 on the FP64 tensor cores (tc_type1_f64.cuh), its
// geometry (rows, cols, group, run, chunk) from ops/cuda_nufft.py
// type1_2d_geometry
int gpq_nufft1_2d_f64(const void* x, const void* v, double h, int n, int m,
                      int fft_order, int rows, int cols, int group, int run,
                      int chunk, void* partial, void* out, void* stream) {
  return launch_type1_f64<Type1F64Grid2D, 1>(x, v, h, n, m, 1, fft_order,
                                             rows, cols, group, 1, run, chunk,
                                             partial, out, stream);
}

int gpq_nufft1_2d_batched_f64(const void* x, const void* v, double h, int n,
                              int m, int nb, int fft_order, int rows,
                              int cols, int group, int run, int chunk,
                              void* partial, void* out, void* stream) {
  return launch_type1_f64<Type1F64Grid2D, TCB_GROUP>(
      x, v, h, n, m, nb, fft_order, rows, cols, group, 1, run, chunk, partial,
      out, stream);
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
  // the one tile width of the d=2 geometry (ops/cuda_nufft.py
  // type2_2d_geometry): 128 columns
  return launch_type2_tc<Type2Grid2D, 2>(x, f, h, n, m, nb, fft_order,
                                         points, cols, stage, 1, scratch,
                                         scratch_floats, out, stream);
}

// the float64 type-2 on the FP64 tensor cores (tc_type2_f64.cuh), batched
// and at B 1, its geometry (points, cols, stage) from ops/cuda_nufft.py
// type2_2d_geometry (float64) and type2_2d_single_geometry, the split F's
// scratch and its size in doubles before the output
int gpq_nufft2_2d_batched_tc_f64(const void* x, const void* f, double h,
                                 int n, int m, int nb, int fft_order,
                                 int points, int cols, int stage,
                                 void* scratch, long long scratch_doubles,
                                 void* out, void* stream) {
  return launch_type2_f64<Type2F64Grid2D>(x, f, h, n, m, nb, fft_order,
                                          points, cols, stage, 1, 1, scratch,
                                          scratch_doubles, out, stream);
}

int gpq_nufft2_2d_tc_f64(const void* x, const void* f, double h, int n,
                         int m, int fft_order, int points, int cols,
                         int stage, void* scratch, long long scratch_doubles,
                         void* out, void* stream) {
  return launch_type2_f64<Type2F64Grid2D>(x, f, h, n, m, 1, fft_order,
                                          points, cols, stage, 1, 1, scratch,
                                          scratch_doubles, out, stream);
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

}  // extern "C"
