// Fused d=1 NUFFT kernels for Hopper (sm_90a), written by hand.
//
//   nufft2_1d (type-2, uniform -> points) replaces pallas_nufft2_1d
//   (gpquad/ops/pallas_nufft.py):
//       out[b,n] = sum_j f[b,j] e^{+2 pi i c(n,j)}
//   nufft1_1d (type-1, points -> uniform) replaces pallas_nufft1_1d:
//       out[b,j] = sum_n v[b,n] e^{-2 pi i c(n,j)}
//
// c(n,j) is the phase in cycles of point n at mode k_j, made on the fly as
// nufft_common.cuh describes, with the rounding error of t = x*h carried
// into the phase (torus_split / phase_split): the modes reach |k| = 4095 at
// d=1, and without it the f32 rounding of t alone is ~1e-4 of the sums
// there.  Nothing of size N x mtot reaches device memory.  One kernel per
// type takes any odd mtot (the modes are tiled inside) and a leading batch
// of B vectors in one launch, where gpquad maps the single TPU kernel over
// the batch with lax.map.
//
// What bounds them on an H100: at d=1 each phase serves one complex
// multiply-add per vector (8 flops), against ~20 flops to make the phase, so
// the phases are most of the work; per point the kernels read 4-8 bytes of x
// and 8-16 of value, so they are bound by operations (fp32 outside the tensor
// cores), not by bytes.  Every phase is made with the exact compensated path
// and sincospi (no rotation recurrence); in float32 and in float64 both
// types cut the phases from mtot a point to a few tens with a split of the
// mode index and run the products on the tensor cores (3xTF32 in float32,
// the FP64 tensor cores in float64):
//
//  - nufft2_1d in float32 (where ops/cuda_nufft.py type2_1d_geometry sends
//    it): tc_type2.cuh's tensor-core kernel (3xTF32) on a split of the
//    mode index, k = K q + r (Type2Split1D below): a GEMM over q whose rows
//    are the points and columns (vector, r), the sum over r in its
//    epilogue; K + Q phases a point instead of mtot, each with
//    phase_split;
//  - nufft2_1d in float64 (where type2_1d_geometry at float64 sends it):
//    tc_type2_f64.cuh's FP64 tensor-core kernel (DMMA) on Type2F64Split1D
//    below, the same GEMM over q and epilogue over r with K a power of two
//    (32 at the light curve's 919 modes, 1 at the samplers' 15 and 17, the
//    columns then the vectors), each operand index split again into a
//    coarse and a fine factor, the column tiles split over a grid axis for
//    few points;
//  - nufft2_1d on the CUDA cores (the float64 and float32 calls the
//    geometry keeps there: few points at small mtot, and the control phase
//    3 times beside the tensor cores):
//    one point per thread (or per S = 8 threads when the
//    point-vectors are fewer than 65 536, e.g. 5 000 targets, so that enough
//    warps fill the card; each takes every S-th mode of the staged tile and
//    the S sums are added in a fixed order in shared memory at the end).  A
//    tile of TK modes of the group's VB vectors is staged in shared memory
//    and read as a broadcast; each phase is made once and applied to all VB.
//  - nufft1_1d in float32: tc_type1.cuh's tensor-core kernel (3xTF32) on a
//    split of the mode index, k = K q + r (Type1Split1D below): a GEMM over
//    the points whose rows are (vector, r) and columns q, the phases
//    e^{-2 pi i r t} and e^{-2 pi i K q t} made per point, K + (columns)
//    of them instead of mtot, each with phase_split so that the rounding of
//    t = x*h goes into both; the (q, r) outside mtot are cropped in the
//    epilogue, and the groups' partials added in group order in double.
//  - nufft1_1d in float64 (where type1_1d_geometry at float64 sends it):
//    tc_type1_f64.cuh's FP64 tensor-core kernel (DMMA) on Type1F64Split1D
//    below, rows r and columns q of k = S q + r (S a power of two), each
//    operand index split again into a coarse and a fine factor: 28 phases
//    a point for the light curve's 919 outputs, one 64 x 32 tile, the card
//    filled by point groups whose partials are added in group order;
//  - nufft1_1d on the CUDA cores (the float64 calls the geometry keeps
//    there: one run of points and more output tiles than SMs, and the
//    float32 control phase 3 times beside the tensor cores): the sum runs
//    over points, so it is the
//    deterministic two-stage reduction of nufft1_2d: a block owns 128 modes
//    (one a thread), one chunk of 2048 points and one group of G vectors;
//    it stages the points' folded t (and its rounding error) and the
//    group's values in shared memory, makes one phase per point and mode
//    and adds v_b e for every b of the group, in runs of SUB points.  The
//    per-chunk partials (nchunk x B x mtot) are then added in chunk order
//    by a second kernel.  No atomics.
//
// The CUDA-core kernels are templated on the scalar type: the float64 calls
// the geometry keeps on the CUDA cores run a double instance of the float
// code.  Every phase of the float64 kernels carries the rounding error of
// t = x h as the float32 ones do (phase_split<double>).
//
// C interface (bound with ctypes): pointers and the stream are void*, each
// function returns cudaGetLastError() after its launches.

#include "tc_type2.cuh"
#include "tc_type2_f64.cuh"

namespace {

// The type-1 sum of a chunk adds runs of SUB points apart and then the runs'
// sums.  Sorted 1-D points (a time series) keep a chunk's partial sums near
// their largest, ~2048, at the low modes, and there the f32 rounding of a
// plain running sum put ~1e-2 on a light curve's signal-variance gradient (a
// component that cancels two terms of ~n/2); with runs of 32 it reads as the
// f32 plain path does.  The type-2 sum is left plain: its rounding did not
// show there.
constexpr int SUB = 32;

// ---------------------------------------------------------------------------
// type-2: block = P = THREADS / S points x S threads per point, one group of
// up to VB vectors (grid axis y).  Thread (p, s) = (tid % P, tid / P).
// ---------------------------------------------------------------------------
template <typename T, int THREADS, int S, int VB, int TK>
__global__ void __launch_bounds__(THREADS)
nufft2_1d_kernel(const T* __restrict__ x, const v2_t<T>* __restrict__ f,
                 T h, int n, int m, int nb, int fft_order,
                 v2_t<T>* __restrict__ out) {
  constexpr int P = THREADS / S;
  __shared__ v2_t<T> ftile[VB][TK];
  __shared__ v2_t<T> red[S][P];
  const int p = threadIdx.x % P;
  const int s = threadIdx.x / P;
  const int i = blockIdx.x * P + p;
  const int b0 = blockIdx.y * VB;
  // live vectors of this group; a constant 1 for the single-vector instance
  const int gn = VB == 1 ? 1 : min(VB, nb - b0);
  const bool live = i < n;
  T te = 0;
  const T u = live ? torus_split(x[i], h, &te) : T(0);
  T acc_re[VB], acc_im[VB];
#pragma unroll
  for (int g = 0; g < VB; ++g) {
    acc_re[g] = 0;
    acc_im[g] = 0;
  }
  for (int k0 = 0; k0 < m; k0 += TK) {
    const int kn = min(TK, m - k0);
    __syncthreads();
    for (int e = threadIdx.x; e < VB * TK; e += THREADS) {
      const int g = e / TK, kk = e % TK;
      v2_t<T> val;
      val.x = 0;
      val.y = 0;
      if (g < gn && kk < kn) val = f[(size_t)(b0 + g) * m + k0 + kk];
      ftile[g][kk] = val;
    }
    __syncthreads();
    for (int kk = s; kk < kn; kk += S) {
      T c, sn;
      phase_split(u, te, mode_value<T>(k0 + kk, m, fft_order), &c, &sn);
#pragma unroll
      for (int g = 0; g < VB; ++g) {
        if (g < gn) {   // uniform over the block
          const v2_t<T> a = ftile[g][kk];
          acc_re[g] = fma(a.x, c, fma(-a.y, sn, acc_re[g]));
          acc_im[g] = fma(a.x, sn, fma(a.y, c, acc_im[g]));
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < VB; ++g) {
    if (g < gn) {   // uniform over the block
      if constexpr (S > 1) {
        __syncthreads();
        red[s][p].x = acc_re[g];
        red[s][p].y = acc_im[g];
        __syncthreads();
        if (s == 0) {
          T re = 0, im = 0;
#pragma unroll
          for (int ss = 0; ss < S; ++ss) {
            re += red[ss][p].x;
            im += red[ss][p].y;
          }
          acc_re[g] = re;
          acc_im[g] = im;
        }
      }
      if (live && s == 0) {
        v2_t<T> o;
        o.x = acc_re[g];
        o.y = acc_im[g];
        out[(size_t)(b0 + g) * n + i] = o;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// type-1 stage 1: partial[c, b, j] = sum over the points of chunk c of
// v[b,n] e(n,j), e = e^{-2 pi i c}.  Block = T1_THREADS modes (one a thread,
// grid axis x), one chunk (grid axis y), one group of up to G vectors (grid
// axis z).
// ---------------------------------------------------------------------------
constexpr int T1_THREADS = 128;

template <typename T, int P, int G>
__global__ void __launch_bounds__(T1_THREADS)
nufft1_1d_partial_kernel(const T* __restrict__ x,
                         const v2_t<T>* __restrict__ v, T h, int n, int m,
                         int nb, int fft_order, int chunk,
                         v2_t<T>* __restrict__ partial) {
  __shared__ T su[P], ste[P];
  __shared__ v2_t<T> sv[G][P];
  const int j = blockIdx.x * T1_THREADS + threadIdx.x;
  const bool live = j < m;
  // dead threads take mode 0 and keep the block's barriers; they write nothing
  const T k = mode_value<T>(live ? j : 0, m, fft_order);
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
    for (int q = threadIdx.x; q < pn; q += T1_THREADS)
      su[q] = torus_split(x[p0 + q], h, &ste[q]);
    for (int e = threadIdx.x; e < G * P; e += T1_THREADS) {
      const int g = e / P, q = e % P;
      v2_t<T> val;
      val.x = 0;
      val.y = 0;
      if (g < gn && q < pn) val = v[(size_t)(b0 + g) * n + p0 + q];
      sv[g][q] = val;
    }
    __syncthreads();
    // each run of SUB points is summed apart, then added to the total
    for (int q0 = 0; q0 < pn; q0 += SUB) {
      const int qe = min(pn, q0 + SUB);
      T sub_re[G], sub_im[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        sub_re[g] = 0;
        sub_im[g] = 0;
      }
      for (int q = q0; q < qe; ++q) {
        T c, sn;
        phase_split(su[q], ste[q], k, &c, &sn);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < gn) {   // uniform over the block
            const v2_t<T> a = sv[g][q];
            // (ar + i ai)(c - i s)
            sub_re[g] = fma(a.x, c, fma(a.y, sn, sub_re[g]));
            sub_im[g] = fma(a.y, c, fma(-a.x, sn, sub_im[g]));
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc_re[g] += sub_re[g];
        acc_im[g] += sub_im[g];
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
        partial[((size_t)blockIdx.y * nb + b0 + g) * m + j] = o;
      }
    }
  }
}

// Type-2: 128 threads a block; one thread per point when there are many
// point-vectors, S = 8 when there are few.  A batch runs in groups of 4
// vectors, a single vector in the VB = 1 instance.  Type-1: groups of 8.
constexpr int T2_THREADS = 128;
constexpr int T2_FEW_POINTS = 65536;
constexpr int T2_GROUP = 4;
constexpr int T1_GROUP = 8;

template <typename T, int S, int VB>
int launch_nufft2_sv(const void* x, const void* f, T h, int n, int m, int nb,
                     int fft_order, void* out, cudaStream_t st) {
  constexpr int TK = sizeof(T) == 4 ? 256 : 128;
  constexpr int P = T2_THREADS / S;
  const dim3 grid((n + P - 1) / P, (nb + VB - 1) / VB);
  nufft2_1d_kernel<T, T2_THREADS, S, VB, TK><<<grid, T2_THREADS, 0, st>>>(
      (const T*)x, (const v2_t<T>*)f, h, n, m, nb, fft_order, (v2_t<T>*)out);
  return (int)cudaGetLastError();
}

template <typename T, int S>
int launch_nufft2_s(const void* x, const void* f, T h, int n, int m, int nb,
                    int fft_order, void* out, cudaStream_t st) {
  if (nb == 1)
    return launch_nufft2_sv<T, S, 1>(x, f, h, n, m, nb, fft_order, out, st);
  return launch_nufft2_sv<T, S, T2_GROUP>(x, f, h, n, m, nb, fft_order, out,
                                          st);
}

template <typename T>
int launch_nufft2(const void* x, const void* f, T h, int n, int m, int nb,
                  int fft_order, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)n * nb < T2_FEW_POINTS)
    return launch_nufft2_s<T, 8>(x, f, h, n, m, nb, fft_order, out, st);
  return launch_nufft2_s<T, 1>(x, f, h, n, m, nb, fft_order, out, st);
}

template <typename T, int G>
int launch_nufft1_g(const void* x, const void* v, T h, int n, int m, int nb,
                    int fft_order, int chunk, void* partial, cudaStream_t st) {
  constexpr int P = sizeof(T) == 4 ? 256 : 128;
  const int nchunk = (n + chunk - 1) / chunk;
  const dim3 grid((m + T1_THREADS - 1) / T1_THREADS, nchunk,
                  (nb + G - 1) / G);
  nufft1_1d_partial_kernel<T, P, G><<<grid, T1_THREADS, 0, st>>>(
      (const T*)x, (const v2_t<T>*)v, h, n, m, nb, fft_order, chunk,
      (v2_t<T>*)partial);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nufft1(const void* x, const void* v, T h, int n, int m, int nb,
                  int fft_order, int chunk, void* partial, void* out,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err = nb == 1
      ? launch_nufft1_g<T, 1>(x, v, h, n, m, nb, fft_order, chunk, partial, st)
      : launch_nufft1_g<T, T1_GROUP>(x, v, h, n, m, nb, fft_order, chunk,
                                     partial, st);
  if (err != 0) return err;
  const int nchunk = (n + chunk - 1) / chunk;
  return launch_reduce<T>(partial, nchunk, nb * m, out, st);
}

// ---------------------------------------------------------------------------
// type-1 in float32 on the tensor cores: tc_type1.cuh's kernel on the split
// k = K q + r, K = TJ (64 for one vector, 32 for a batch in pairs): row r in
// 0..K-1, column qi the q = qmin + qi of qmin = -ceil(half / K) ..
// floor(half / K), half = (m - 1) / 2; output k if |k| <= half (index
// k + half, or the FFT order's k mod m).  The stage coordinates are the
// torus coordinate u and the rounding error te of t = x*h (torus_split);
// both phases take them (phase_split), the column's at mode value K q.
// ---------------------------------------------------------------------------
struct Type1Split1D {
  using X = float;
  using Acc = double;
  using Row = float;
  using Col = float;
  static constexpr int kTab = 0;
  // (no third coordinate: the phases do not read it)
  static __device__ void point(X xp, float h, float* a, float* b, float*) {
    *a = torus_split(xp, h, b);
  }
  static __device__ void row_phase(float a, float b, float, const float2*,
                                   float k, float* c, float* s) {
    phase_split(a, b, k, c, s);
  }
  static __device__ void col_phase(float a, float b, float, const float2*,
                                   float k, float* c, float* s) {
    phase_split(a, b, k, c, s);
  }
  template <int K>
  static __host__ __device__ int qmin(int m) {
    return -(((m - 1) / 2 + K - 1) / K);
  }
  template <int K>
  static __device__ float row_mode(int r, int, int, bool* ok) {
    *ok = true;
    return (float)r;
  }
  template <int K, int COLS>
  static __device__ float col_mode(int qi, int m, int, bool* ok) {
    *ok = qi < cols<K>(m);
    return *ok ? (float)(K * (qmin<K>(m) + qi)) : 0.f;
  }
  template <int K>
  static __host__ __device__ int rows(int) { return K; }
  template <int K>
  static __host__ __device__ int cols(int m) {
    return (m - 1) / 2 / K - qmin<K>(m) + 1;
  }
  static __host__ __device__ long long outputs(int m) { return m; }
  template <int K>
  static __device__ long long out_index(int r, int qi, int m, int fft_order) {
    const int half = (m - 1) / 2;
    const int k = K * (qmin<K>(m) + qi) + r;
    if (k < -half || k > half) return -1;
    return fft_order ? (k >= 0 ? k : k + m) : k + half;
  }
};

// ---------------------------------------------------------------------------
// type-2 in float32 on the tensor cores: tc_type2.cuh's kernel on the split
// k = K q + r, K = 32: the reduction runs over q (index qi, q = qmin + qi,
// the Q values that reach every |k| <= half, padded to whole k-steps of 8),
// the epilogue over r in 0..K-1 (one vector's K columns, no pad); F_b[r,
// qi] = f_b at mode K q + r, zero past half.  Both phases take the torus
// coordinate u and the rounding error te of t = x*h (torus_split,
// phase_split), e^{+2 pi i K q t} at mode value K q, e^{+2 pi i r t} at r.
// ---------------------------------------------------------------------------
constexpr int T2S_K = 32;

struct Type2Split1D {
  using X = float;
  static constexpr bool kWholeStages = false;   // red_len: multiples of 8
  static constexpr bool kStagePhases = false;
  static constexpr bool kSplitK = false;
  static __device__ void point(X xp, float h, float* a, float* b) {
    *a = torus_split(xp, h, b);
  }
  static __host__ __device__ int qmin(int m) {
    return -(((m - 1) / 2 + T2S_K - 1) / T2S_K);
  }
  static __host__ __device__ int qcount(int m) {
    return (m - 1) / 2 / T2S_K - qmin(m) + 1;
  }
  static __device__ float red_mode(int k, int m, int, bool* ok) {
    *ok = k < qcount(m);
    return (float)(T2S_K * (qmin(m) + k));
  }
  static __device__ void red_phase(float a, float b, float kv, float* c,
                                   float* s) {
    phase_split(a, b, kv, c, s);
  }
  static __device__ int epi_cols(int) { return T2S_K; }
  static __device__ void epi_phase(float a, float b, int j, int, int,
                                   float* c, float* s) {
    phase_split(a, b, (float)j, c, s);
  }
  static int red_len(int m) { return (qcount(m) + 7) / 8 * 8; }
  static int cols(int) { return T2S_K; }
  static __device__ float2 coef(const float2* __restrict__ f, int b, int j,
                                int k, int m, int fft_order) {
    const int half = (m - 1) / 2;
    const int kk = T2S_K * (qmin(m) + k) + j;
    if (j >= T2S_K || k >= qcount(m) || kk < -half || kk > half)
      return make_float2(0.f, 0.f);
    return f[(size_t)b * m + (fft_order ? (kk >= 0 ? kk : kk + m)
                                        : kk + half)];
  }
};

// ---------------------------------------------------------------------------
// type-1 in float64 on the FP64 tensor cores: tc_type1_f64.cuh's kernel on
// the split k = S q + r, S a power of two (the caller's: ops/cuda_nufft.py
// type1_1d_geometry at float64 picks the one whose tiles pad least): row r
// in 0..S-1, the mode r of the point's coordinate u; column qi the q =
// qmin + qi of qmin = -ceil(half / S) .. floor(half / S), the mode q of
// the coordinate S u (S x is exact, and so is the rounding error of its t),
// so that both operands' indices split into the kernel's coarse and fine
// factors as at d=2 (at a base of 0 for the rows, qmin for the columns);
// output k = S q + r where |k| <= half.  Every phase carries the rounding
// error of its t (kCarry), as the float32 d=1 kernels' do.
// ---------------------------------------------------------------------------
struct Type1F64Split1D {
  using X = double;
  static constexpr int kCoords = 2, kRowCoord = 0, kColCoord = 1;
  static constexpr bool kOuter = false, kCarry = true;
  static constexpr int kMaxSplit = 1024;
  template <int S1, int S2>
  static __host__ __device__ constexpr int max_factors() {
    return 2 * T64_K + S1 + S2;
  }
  template <int S1, int S2>
  static __host__ __device__ constexpr int fixed_factors() {
    return max_factors<S1, S2>();
  }
  static __device__ double coord(X p, int c, int S) {
    return c == 0 ? p : S * p;
  }
  static __host__ __device__ int inner(int) { return 1 << 30; }
  static __host__ __device__ int qmin(int m, int S) {
    return -(((m - 1) / 2 + S - 1) / S);
  }
  static __host__ __device__ int qcount(int m, int S) {
    return (m - 1) / 2 / S - qmin(m, S) + 1;
  }
  static __device__ int row_base(int, int) { return 0; }
  static __device__ int col_base(int m, int S) { return qmin(m, S); }
  static bool split_ok(int, int S) {
    return S >= 1 && S <= kMaxSplit && (S & (S - 1)) == 0;
  }
  static __host__ __device__ int rows(int, int S) { return S; }
  static __host__ __device__ int cols(int m, int S) { return qcount(m, S); }
  static __host__ __device__ long long outputs(int m) { return m; }
  static __device__ long long out_index(int i, int c, int m, int S,
                                        int fft_order) {
    const int half = (m - 1) / 2;
    const int k = S * (qmin(m, S) + c) + i;
    if (i >= S || c >= qcount(m, S) || k < -half || k > half) return -1;
    return fft_order ? (k >= 0 ? k : k + m) : k + half;
  }
};

// ---------------------------------------------------------------------------
// type-2 in float64 on the FP64 tensor cores: tc_type2_f64.cuh's kernel on
// the split k = K q + r, K a power of two (the caller's: ops/cuda_nufft.py
// type2_1d_geometry at float64), as the float32 Type2Split1D: the GEMM
// runs over the values q (index qi, q = qmin + qi, the Q that reach every
// |k| <= half, padded to whole k-steps of 8), the epilogue over r in
// 0..K-1 (a vector's K columns, no pad); F_b[r, qi] = f_b at mode K q + r,
// zero past half.  The reduction's coordinate is K u (K x exact), so that
// k-step s's factor is e(K u, qmin + 8 s) and its entries' e(K u, r'); the
// epilogue's e(u, 8 s) e(u, r') (a base of 0).  A tile holds whole vectors
// (K divides it), so grid axis y may split the column tiles (kSplitCols:
// few points and many vectors).  Every phase carries the rounding error of
// its t (kCarry).
// ---------------------------------------------------------------------------
struct Type2F64Split1D {
  using X = double;
  static constexpr int kCoords = 2, kRedCoord = 1;
  static constexpr int kChunk = 6;   // 48 values q: A kept a block to K 32
                                     // at mtot 1 535
  static constexpr bool kSplitK = false, kSplitCols = true, kCarry = true;
  static constexpr int kMaxSplit = 32;   // K whose columns r fit a tile
  struct Extra {
    double te[kCoords][T2D_P];   // the rounding errors of t = coord h
  };
  static __device__ double coord(X p, int c, int K) {
    return c == 0 ? p : K * p;
  }
  static __host__ __device__ int qmin(int m, int K) {
    return -(((m - 1) / 2 + K - 1) / K);
  }
  static __host__ __device__ int qcount(int m, int K) {
    return (m - 1) / 2 / K - qmin(m, K) + 1;
  }
  static bool split_ok(int, int K) {
    return K >= 1 && K <= kMaxSplit && (K & (K - 1)) == 0;
  }
  static __host__ __device__ int epi_cols(int, int K) { return K; }
  static __device__ int epi_base(int) { return 0; }
  static __host__ __device__ int red_steps(int m, int K) {
    return (qcount(m, K) + 7) / 8;
  }
  static __device__ bool red_ok(int ks, int r, int m, int K) {
    return 8 * ks + r < qcount(m, K);
  }
  // e(K u, qmin + 8 s) of the chunk's k-steps s = ks0 .. ks0 + kn - 1
  template <class S>
  static __device__ void chunk_factors(S& sm, int ks0, int kn, int m, int K,
                                       int tid) {
    const int q0 = qmin(m, K);
    for (int e = tid; e < T2D_P * kChunk; e += T2D_THREADS) {
      const int p = e / kChunk, s = e % kChunk;
      if (s < kn) {
        double c, sn;
        phase_split(sm.u[1][p], sm.ex.te[1][p], (double)(q0 + 8 * (ks0 + s)),
                    &c, &sn);
        sm.s2[p][s] = make_double2(c, sn);
      }
    }
  }
  static __device__ long long coef_index(int b, int j, int k, int m, int K,
                                         int fft_order) {
    const int half = (m - 1) / 2;
    const int kk = K * (qmin(m, K) + k) + j;
    if (k >= qcount(m, K) || kk < -half || kk > half) return -1;
    return (long long)b * m + (fft_order ? (kk >= 0 ? kk : kk + m)
                                         : kk + half);
  }
};

}  // namespace

extern "C" {

int gpq_nufft2_1d_f32(const void* x, const void* f, float h, int n, int m,
                      int nb, int fft_order, void* out, void* stream) {
  return launch_nufft2<float>(x, f, h, n, m, nb, fft_order, out, stream);
}

// float32 on the tensor cores, with the caller's geometry (ops/cuda_nufft.py
// type2_1d_geometry: points a block, K, columns a tile, modes a stage)
int gpq_nufft2_1d_tc_f32(const void* x, const void* f, float h, int n, int m,
                         int nb, int fft_order, int points, int k, int cols,
                         int stage, void* scratch, long long scratch_floats,
                         void* out, void* stream) {
  if (k != T2S_K) return (int)cudaErrorInvalidValue;
  // both tile widths: 32 (one vector's columns) and 128
  return launch_type2_tc<Type2Split1D, 3>(x, f, h, n, m, nb, fft_order,
                                          points, cols, stage, 1, scratch,
                                          scratch_floats, out, stream);
}

int gpq_nufft2_1d_f64(const void* x, const void* f, double h, int n, int m,
                      int nb, int fft_order, void* out, void* stream) {
  return launch_nufft2<double>(x, f, h, n, m, nb, fft_order, out, stream);
}

// float64 on the FP64 tensor cores, with the caller's geometry
// (ops/cuda_nufft.py type2_1d_geometry at float64: points a block, K,
// columns a tile, values q a stage, splits of the column tiles); the
// scratch holds the split f
int gpq_nufft2_1d_tc_f64(const void* x, const void* f, double h, int n,
                         int m, int nb, int fft_order, int points, int k,
                         int cols, int stage, int splits, void* scratch,
                         long long scratch_doubles, void* out,
                         void* stream) {
  return launch_type2_f64<Type2F64Split1D>(x, f, h, n, m, nb, fft_order,
                                           points, cols, stage, k, splits,
                                           scratch, scratch_doubles, out,
                                           stream);
}

int gpq_nufft1_1d_f32(const void* x, const void* v, float h, int n, int m,
                      int nb, int fft_order, int chunk, void* partial,
                      void* out, void* stream) {
  return launch_nufft1<float>(x, v, h, n, m, nb, fft_order, chunk, partial,
                              out, stream);
}

// float32 on the tensor cores, with the caller's geometry (ops/cuda_nufft.py
// type1_1d_geometry): one vector in groups of G = 1, a batch of G = 2
int gpq_nufft1_1d_tc_f32(const void* x, const void* v, float h, int n, int m,
                         int nb, int fft_order, int rows, int cols, int group,
                         int acc, int run, int chunk, void* partial,
                         void* out, void* stream) {
  if (group == 1)
    return launch_type1_tc<Type1Split1D, 1>(x, v, h, n, m, nb, fft_order,
                                            rows, cols, group, acc, run,
                                            chunk, partial, out, stream);
  return launch_type1_tc<Type1Split1D, 2>(x, v, h, n, m, nb, fft_order, rows,
                                          cols, group, acc, run, chunk,
                                          partial, out, stream);
}

int gpq_nufft1_1d_f64(const void* x, const void* v, double h, int n, int m,
                      int nb, int fft_order, int chunk, void* partial,
                      void* out, void* stream) {
  return launch_nufft1<double>(x, v, h, n, m, nb, fft_order, chunk, partial,
                               out, stream);
}

// float64 on the FP64 tensor cores, with the caller's geometry
// (ops/cuda_nufft.py type1_1d_geometry at float64: rows, cols, group,
// split, run, chunk): one vector in groups of G = 1, a batch of G = 2; the
// partial may be the output where the points make one group
int gpq_nufft1_1d_tc_f64(const void* x, const void* v, double h, int n,
                         int m, int nb, int fft_order, int rows, int cols,
                         int group, int split, int run, int chunk,
                         void* partial, void* out, void* stream) {
  if (group == 1)
    return launch_type1_f64<Type1F64Split1D, 1>(x, v, h, n, m, nb, fft_order,
                                                rows, cols, group, split, run,
                                                chunk, partial, out, stream);
  return launch_type1_f64<Type1F64Split1D, 2>(x, v, h, n, m, nb, fft_order,
                                              rows, cols, group, split, run,
                                              chunk, partial, out, stream);
}

}  // extern "C"
