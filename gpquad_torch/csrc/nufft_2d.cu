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
// made on the fly from t = x*h exactly as ops/nufft.py _phase_matrix makes it:
// fold t onto the torus (u = t - rint(t)), form p = u*k and its exact error
// fma(u, k, -p), reduce p, add the error back and reduce again.  rint rounds
// half to even like torch.round / jnp.round.  sin/cos of 2 pi c come from
// sincospi, never from the fast intrinsics.  Every product and sum of the
// phase path is an explicit _rn intrinsic, so nvcc cannot contract it into an
// FMA that would change the rounding the reference does.
//
// Nothing of size N x mtot is ever written to device memory: each kernel
// reads the points once and the mode block once.
//
// What bounds them on an H100: at the slice's shapes both kernels do
// ~8 mtot^2 flops per point of complex multiply-adds against ~16 bytes of
// point data, so they are bound by operations (fp32 outside the tensor
// cores), not by bytes.  This first version is a plain shared-memory design:
//  - type-2: one thread per point; the point's mode-2 phases for a tile of
//    TK modes live in registers, the f tile (TJ x TK) is staged in shared
//    memory and read as a broadcast.  Modes are tiled, so any odd mtot works.
//  - type-1: a reduction over points across blocks.  Stage 1: each block owns
//    a 16 x 16 tile of outputs and one chunk of 2048 points, stages v*E1 and
//    E2 for sub-tiles of P points in shared memory, and writes its partial
//    sum.  Stage 2 adds the partials of all chunks in chunk order.  No
//    atomics: the result is deterministic and the fp32 error of each chunk
//    sum stays bounded, as the chunked type-1 of ops/nufft.py keeps it.
//
// Every kernel is templated on the scalar type: float is the main path, and
// double tensors run a double instance of the same code.
//
// C interface (bound with ctypes): pointers and the stream are void*, each
// function returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

template <typename T> struct V2;
template <> struct V2<float> { using type = float2; };
template <> struct V2<double> { using type = double2; };
template <typename T> using v2_t = typename V2<T>::type;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float rint_(float a) { return rintf(a); }
__device__ __forceinline__ double rint_(double a) { return rint(a); }
__device__ __forceinline__ void sincospi_(float a, float* s, float* c) { sincospif(a, s, c); }
__device__ __forceinline__ void sincospi_(double a, double* s, double* c) { sincospi(a, s, c); }

// u = t - rint(t) for t = x*h.
template <typename T>
__device__ __forceinline__ T torus(T x, T h) {
  T t = mul_rn(x, h);
  return add_rn(t, -rint_(t));
}

// Mode index -> mode value: symmetric -half..half, or FFT order 0..half,
// -half..-1 (gpquad/ops/pallas_nufft.py _k_values).
template <typename T>
__device__ __forceinline__ T mode_value(int j, int m, int fft_order) {
  int half = (m - 1) / 2;
  int k = fft_order ? (j <= half ? j : j - m) : j - half;
  return static_cast<T>(k);
}

// cos and sin of 2 pi c, c the compensated reduced cycles of u*k.
template <typename T>
__device__ __forceinline__ void phase(T u, T k, T* c, T* s) {
  T p = mul_rn(u, k);
  T err = fma_rn(u, k, -p);              // exact: u*k - p
  T cyc = add_rn(p, -rint_(p));
  cyc = add_rn(cyc, err);
  cyc = add_rn(cyc, -rint_(cyc));        // |cyc| <= 1/2
  sincospi_(add_rn(cyc, cyc), s, c);
}

constexpr int T2_THREADS = 64;

// ---------------------------------------------------------------------------
// type-2: out[n] = sum_j e1(n,j) sum_k f[j,k] e2(n,k),  e = e^{+2 pi i c}
// ---------------------------------------------------------------------------
template <typename T, int TJ, int TK>
__global__ void __launch_bounds__(T2_THREADS)
nufft2_2d_kernel(const v2_t<T>* __restrict__ x, const v2_t<T>* __restrict__ f,
                 T h, int n, int m, int fft_order, v2_t<T>* __restrict__ out) {
  __shared__ v2_t<T> ftile[TJ][TK];
  const int i = blockIdx.x * T2_THREADS + threadIdx.x;
  const bool live = i < n;
  T u1 = 0, u2 = 0;
  if (live) {
    v2_t<T> xi = x[i];
    u1 = torus(xi.x, h);
    u2 = torus(xi.y, h);
  }
  T acc_re = 0, acc_im = 0;
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
      for (int e = threadIdx.x; e < TJ * TK; e += T2_THREADS) {
        const int jj = e / TK, kk = e % TK;
        const int j = j0 + jj, k = k0 + kk;
        v2_t<T> val;
        val.x = 0;
        val.y = 0;
        if (j < m && k < m) val = f[(size_t)j * m + k];
        ftile[jj][kk] = val;
      }
      __syncthreads();
      const int jn = min(TJ, m - j0);
      for (int jj = 0; jj < jn; ++jj) {
        T tr = 0, ti = 0;
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
          const v2_t<T> a = ftile[jj][kk];
          tr = fma(a.x, c2[kk], fma(-a.y, s2[kk], tr));
          ti = fma(a.x, s2[kk], fma(a.y, c2[kk], ti));
        }
        T c1, s1;
        phase(u1, mode_value<T>(j0 + jj, m, fft_order), &c1, &s1);
        acc_re = fma(c1, tr, fma(-s1, ti, acc_re));
        acc_im = fma(c1, ti, fma(s1, tr, acc_im));
      }
    }
  }
  if (live) {
    v2_t<T> o;
    o.x = acc_re;
    o.y = acc_im;
    out[i] = o;
  }
}

// ---------------------------------------------------------------------------
// type-1 stage 1: partial[c, j, k] = sum_{n in chunk c} v_n e1(n,j) e2(n,k),
// e = e^{-2 pi i c}.  Block = one TJ x TK output tile, one chunk of points.
// ---------------------------------------------------------------------------
constexpr int T1_TJ = 16;
constexpr int T1_TK = 16;
constexpr int T1_THREADS = T1_TJ * T1_TK;

template <typename T, int P>
__global__ void __launch_bounds__(T1_THREADS)
nufft1_2d_partial_kernel(const v2_t<T>* __restrict__ x, const v2_t<T>* __restrict__ v,
                         T h, int n, int m, int fft_order, int chunk,
                         v2_t<T>* __restrict__ partial) {
  __shared__ T su1[P], su2[P];
  __shared__ v2_t<T> sv[P];
  __shared__ v2_t<T> w1[P][T1_TJ];   // v_p * e1(p, j)
  __shared__ v2_t<T> e2[P][T1_TK];   // e2(p, k)
  const int ntk = (m + T1_TK - 1) / T1_TK;
  const int j0 = (blockIdx.x / ntk) * T1_TJ;
  const int k0 = (blockIdx.x % ntk) * T1_TK;
  const int jj = threadIdx.x / T1_TK, kk = threadIdx.x % T1_TK;
  const int p_begin = blockIdx.y * chunk;
  const int p_end = min(n, p_begin + chunk);
  T acc_re = 0, acc_im = 0;
  for (int p0 = p_begin; p0 < p_end; p0 += P) {
    const int pn = min(P, p_end - p0);
    __syncthreads();
    for (int q = threadIdx.x; q < pn; q += T1_THREADS) {
      const v2_t<T> xq = x[p0 + q];
      su1[q] = torus(xq.x, h);
      su2[q] = torus(xq.y, h);
      sv[q] = v[p0 + q];
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
        const v2_t<T> vq = sv[q];
        // (c - i s)(vr + i vi)
        w.x = fma(c, vq.x, s * vq.y);
        w.y = fma(c, vq.y, -s * vq.x);
      }
      w1[q][a] = w;
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
      const v2_t<T> a = w1[q][jj];
      const v2_t<T> b = e2[q][kk];
      acc_re = fma(a.x, b.x, fma(-a.y, b.y, acc_re));
      acc_im = fma(a.x, b.y, fma(a.y, b.x, acc_im));
    }
  }
  if (j0 + jj < m && k0 + kk < m) {
    v2_t<T> o;
    o.x = acc_re;
    o.y = acc_im;
    partial[((size_t)blockIdx.y * m + (j0 + jj)) * m + (k0 + kk)] = o;
  }
}

// type-1 stage 2: out[jk] = sum_c partial[c, jk], in chunk order.
template <typename T>
__global__ void nufft1_2d_reduce_kernel(const v2_t<T>* __restrict__ partial,
                                        int nchunk, int mm,
                                        v2_t<T>* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mm) return;
  T re = 0, im = 0;
  for (int c = 0; c < nchunk; ++c) {
    const v2_t<T> p = partial[(size_t)c * mm + idx];
    re += p.x;
    im += p.y;
  }
  v2_t<T> o;
  o.x = re;
  o.y = im;
  out[idx] = o;
}

template <typename T>
int launch_nufft2(const void* x, const void* f, T h, int n, int m, int fft_order,
                  void* out, void* stream) {
  constexpr int TJ = 32;
  constexpr int TK = sizeof(T) == 4 ? 32 : 16;
  const dim3 grid((n + T2_THREADS - 1) / T2_THREADS);
  nufft2_2d_kernel<T, TJ, TK><<<grid, T2_THREADS, 0, (cudaStream_t)stream>>>(
      (const v2_t<T>*)x, (const v2_t<T>*)f, h, n, m, fft_order, (v2_t<T>*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nufft1(const void* x, const void* v, T h, int n, int m, int fft_order,
                  int chunk, void* partial, void* out, void* stream) {
  constexpr int P = sizeof(T) == 4 ? 128 : 64;
  const int ntj = (m + T1_TJ - 1) / T1_TJ;
  const int nchunk = (n + chunk - 1) / chunk;
  const dim3 grid(ntj * ntj, nchunk);
  cudaStream_t s = (cudaStream_t)stream;
  nufft1_2d_partial_kernel<T, P><<<grid, T1_THREADS, 0, s>>>(
      (const v2_t<T>*)x, (const v2_t<T>*)v, h, n, m, fft_order, chunk,
      (v2_t<T>*)partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int mm = m * m;
  nufft1_2d_reduce_kernel<T><<<(mm + 255) / 256, 256, 0, s>>>(
      (const v2_t<T>*)partial, nchunk, mm, (v2_t<T>*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gpq_nufft2_2d_f32(const void* x, const void* f, float h, int n, int m,
                      int fft_order, void* out, void* stream) {
  return launch_nufft2<float>(x, f, h, n, m, fft_order, out, stream);
}

int gpq_nufft2_2d_f64(const void* x, const void* f, double h, int n, int m,
                      int fft_order, void* out, void* stream) {
  return launch_nufft2<double>(x, f, h, n, m, fft_order, out, stream);
}

int gpq_nufft1_2d_f32(const void* x, const void* v, float h, int n, int m,
                      int fft_order, int chunk, void* partial, void* out,
                      void* stream) {
  return launch_nufft1<float>(x, v, h, n, m, fft_order, chunk, partial, out, stream);
}

int gpq_nufft1_2d_f64(const void* x, const void* v, double h, int n, int m,
                      int fft_order, int chunk, void* partial, void* out,
                      void* stream) {
  return launch_nufft1<double>(x, v, h, n, m, fft_order, chunk, partial, out, stream);
}

}  // extern "C"
