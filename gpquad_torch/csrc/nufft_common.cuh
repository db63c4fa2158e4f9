// Device helpers shared by the hand-written NUFFT kernels (nufft_1d.cu,
// nufft_2d.cu, nufft_3d.cu): the complex vector types, the rounding-exact
// arithmetic of the phase path, and the chunk-order reduction of the type-1
// partial sums.
//
// c_t(n,j) is the phase in cycles of point n along dimension t at mode k_j,
// made on the fly from t = x*h exactly as ops/nufft.py _phase_matrix makes it:
// fold t onto the torus (u = t - rint(t)), form p = u*k and its exact error
// fma(u, k, -p), reduce p, add the error back and reduce again.  rint rounds
// half to even like torch.round / jnp.round.  sin/cos of 2 pi c come from
// sincospi, never from the fast intrinsics.  Every product and sum of the
// phase path is an explicit _rn intrinsic, so nvcc cannot contract it into an
// FMA that would change the rounding the reference does.
#pragma once

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

// The d=1 kernels' form of torus() and phase(): the rounding error of
// t = x*h, te = fma(x, h, -t) (exact), goes into the phase with the error of
// u*k, so that it does not grow with |k| (at d=1 the modes reach |k| = 4095,
// where the rounding of t alone puts ~1e-4 on an f32 sum).  u = t - rint(t)
// is exact.
template <typename T>
__device__ __forceinline__ T torus_split(T x, T h, T* te) {
  T t = mul_rn(x, h);
  *te = fma_rn(x, h, -t);
  return add_rn(t, -rint_(t));
}

template <typename T>
__device__ __forceinline__ void phase_split(T u, T te, T k, T* c, T* s) {
  T p = mul_rn(u, k);
  T err = fma_rn(te, k, fma_rn(u, k, -p));   // (u*k - p) + te*k
  T cyc = add_rn(p, -rint_(p));
  cyc = add_rn(cyc, err);
  cyc = add_rn(cyc, -rint_(cyc));            // |cyc| <= 1/2
  sincospi_(add_rn(cyc, cyc), s, c);
}

// Type-1 stage 2: out[i] = sum_c partial[c, i] over the mm outputs, in chunk
// (or chunk-group) order, the sum in Acc and rounded to T once.
template <typename T, typename Acc>
__global__ void nufft1_reduce_kernel(const v2_t<T>* __restrict__ partial,
                                     int nchunk, int mm,
                                     v2_t<T>* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mm) return;
  Acc re = 0, im = 0;
  for (int c = 0; c < nchunk; ++c) {
    const v2_t<T> p = partial[(size_t)c * mm + idx];
    re += p.x;
    im += p.y;
  }
  v2_t<T> o;
  o.x = (T)re;
  o.y = (T)im;
  out[idx] = o;
}

template <typename T, typename Acc = T>
int launch_reduce(const void* partial, int nchunk, int mm, void* out,
                  cudaStream_t s) {
  nufft1_reduce_kernel<T, Acc><<<(mm + 255) / 256, 256, 0, s>>>(
      (const v2_t<T>*)partial, nchunk, mm, (v2_t<T>*)out);
  return (int)cudaGetLastError();
}

}  // namespace
