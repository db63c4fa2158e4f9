// Hand-written CUDA kernels for SKI's d=2 cubic interpolation (4x4 stencils)
// on the band plan of gpquad_torch/models/ski.py.
//
// interp_T_2d replaces gpquad/ops/pallas_interp.py pallas_interp_T_2d (:104):
// the band slabs of W^T u (points -> grid).  interp_2d replaces
// pallas_interp_2d (:237): W v read back at the band-sorted slots (grid ->
// points).  The TPU kernels build one-hot row and column selectors to feed
// the MXU (pallas_interp.py:67-92); a GPU needs no selectors, so these
// kernels address the stencil directly.
//
// Both are bound by bytes on an H100: each slot and vector moves one value
// and its tables (~40 B in f32) against ~40 flops.  The designs:
//
// interp_T: one block per (band, 128-column tile, group of BB vectors); one
// thread per slab column holds that column's (bh+3) x BB sums in registers.
// The band's table slots are staged through shared memory in slot order.
// Each warp tests 32 staged slots at once against its 32 columns (a ballot)
// and walks only the slots whose stencil reaches them and carries a nonzero
// value, in slot order; the thread whose column a stencil covers adds its
// contributions.  (The plan fills every padded slot with the tables of one
// point, so without the value test the warp holding that point's columns
// would walk all ~1100 padded slots of every band; a zero value adds
// nothing.)  So each
// cell's sum is taken in one fixed order, with no atomics, and the result
// does not change from run to run (an unordered float atomic would move CG
// iteration counts between runs).  Rows and columns outside the slab are
// skipped: padded slots carry the tables of a point of another band, so
// i0loc + j may lie anywhere (their u is zero).
//
// interp: one thread per slot, looping over a group of vectors; each reads
// its 4x4 stencil from the band's slab.  The slab input is a strided view
// (batch, band, row strides given; columns contiguous), so the caller passes
// an overlapping view of the padded grid instead of a gathered copy.  Slots
// whose stencil leaves the slab (padded slots) sum only the cells inside it:
// their values are not read back.
#include <cuda_runtime.h>

namespace {

constexpr int T_COLS = 128;     // slab columns per interp_T block
constexpr int T_CHUNK = 256;    // table slots staged per step
constexpr int T_ROWS = 11;      // slab height bh + 3 at the plan's bh = 8
constexpr int F_THREADS = 256;  // slots per interp block
constexpr int F_BATCH = 16;     // vectors per interp block

template <typename T, int BB>
__global__ void __launch_bounds__(T_COLS)
interp_T_kernel(const T* __restrict__ us, const int* __restrict__ i0loc,
                const int* __restrict__ c0, const T* __restrict__ w_row,
                const T* __restrict__ w_col, int B, int nbands, int cap,
                int G2, T* __restrict__ out) {
  __shared__ int s_i0[T_CHUNK];
  __shared__ int s_c0[T_CHUNK];
  __shared__ T s_wr[T_CHUNK][4];
  __shared__ T s_wc[T_CHUNK][4];
  __shared__ T s_u[BB][T_CHUNK];

  const int band = blockIdx.x;
  const int col = blockIdx.y * T_COLS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int wcol0 = col - lane;          // the warp's first column
  const int b0 = blockIdx.z * BB;
  const int nb = min(BB, B - b0);

  T acc[T_ROWS][BB];
#pragma unroll
  for (int r = 0; r < T_ROWS; ++r)
#pragma unroll
    for (int b = 0; b < BB; ++b) acc[r][b] = T(0);

  for (int s0 = 0; s0 < cap; s0 += T_CHUNK) {
    const int cnt = min(T_CHUNK, cap - s0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += T_COLS) {
      const size_t slot = (size_t)band * cap + s0 + i;
      s_i0[i] = i0loc[slot];
      s_c0[i] = c0[slot];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_wr[i][j] = w_row[slot * 4 + j];
        s_wc[i][j] = w_col[slot * 4 + j];
      }
#pragma unroll
      for (int b = 0; b < BB; ++b)
        s_u[b][i] = b < nb
            ? us[((size_t)(b0 + b) * nbands + band) * cap + s0 + i] : T(0);
    }
    __syncthreads();
    for (int base = 0; base < cnt; base += 32) {
      // slots whose columns c0..c0+3 meet the warp's wcol0..wcol0+31
      const int mine = base + lane;
      bool near = mine < cnt && (unsigned)(wcol0 + 31 - s_c0[mine]) < 35u &&
                  (unsigned)(s_i0[mine] + 3) < (unsigned)(T_ROWS + 3);
      if (near) {
        bool nonzero = false;
#pragma unroll
        for (int b = 0; b < BB; ++b) nonzero |= s_u[b][mine] != T(0);
        near = nonzero;
      }
      unsigned hits = __ballot_sync(0xffffffffu, near);
      while (hits) {
        const int i = base + __ffs(hits) - 1;
        hits &= hits - 1;
        const unsigned jc = (unsigned)(col - s_c0[i]);
        if (jc >= 4u) continue;
        const T wc = s_wc[i][jc];
        const int i0 = s_i0[i];
        const T w0 = s_wr[i][0], w1 = s_wr[i][1], w2 = s_wr[i][2],
                w3 = s_wr[i][3];
        T u[BB];
#pragma unroll
        for (int b = 0; b < BB; ++b) u[b] = s_u[b][i];
#pragma unroll
        for (int r = 0; r < T_ROWS; ++r) {
          const int jr = r - i0;
          if ((unsigned)jr < 4u) {
            const T wr = jr == 0 ? w0 : jr == 1 ? w1 : jr == 2 ? w2 : w3;
#pragma unroll
            for (int b = 0; b < BB; ++b) acc[r][b] += (wr * u[b]) * wc;
          }
        }
      }
    }
  }
  if (col >= G2) return;
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    if (b < nb) {
      T* o = out + ((size_t)band * B + b0 + b) * T_ROWS * G2 + col;
#pragma unroll
      for (int r = 0; r < T_ROWS; ++r) o[(size_t)r * G2] = acc[r][b];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(F_THREADS)
interp_kernel(const T* __restrict__ vs, long long s_batch, long long s_band,
              long long s_row, const int* __restrict__ i0loc,
              const int* __restrict__ c0, const T* __restrict__ w_row,
              const T* __restrict__ w_col, int B, int nbands, int cap,
              int rows, int G2, T* __restrict__ out) {
  const int p = blockIdx.x * F_THREADS + threadIdx.x;
  const int band = blockIdx.y;
  if (p >= cap) return;
  const size_t slot = (size_t)band * cap + p;
  const int i0 = i0loc[slot];
  const int cc = c0[slot];
  T wr[4], wc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wr[j] = w_row[slot * 4 + j];
    wc[j] = w_col[slot * 4 + j];
  }
  const T* base = vs + (long long)band * s_band;
  const int b_end = min(B, (int)(blockIdx.z + 1) * F_BATCH);
  for (int b = blockIdx.z * F_BATCH; b < b_end; ++b) {
    const T* g = base + (long long)b * s_batch;
    T acc = T(0);
#pragma unroll
    for (int jc = 0; jc < 4; ++jc) {
      const int col = cc + jc;
      if ((unsigned)col >= (unsigned)G2) continue;
      T inner = T(0);
#pragma unroll
      for (int jr = 0; jr < 4; ++jr) {
        const int row = i0 + jr;
        if ((unsigned)row < (unsigned)rows)
          inner += wr[jr] * g[(long long)row * s_row + col];
      }
      acc += inner * wc[jc];
    }
    out[((size_t)band * B + b) * cap + p] = acc;
  }
}

template <typename T, int BB>
int launch_interp_T_g(const void* us, const void* i0loc, const void* c0,
                      const void* w_row, const void* w_col, int B, int nbands,
                      int cap, int G2, void* out, cudaStream_t st) {
  const dim3 grid(nbands, (G2 + T_COLS - 1) / T_COLS, (B + BB - 1) / BB);
  interp_T_kernel<T, BB><<<grid, T_COLS, 0, st>>>(
      (const T*)us, (const int*)i0loc, (const int*)c0, (const T*)w_row,
      (const T*)w_col, B, nbands, cap, G2, (T*)out);
  return (int)cudaGetLastError();
}

// Batch groups: the whole batch when it is small, else groups of 8 vectors
// in float32 and 4 in float64 (11 x BB sums in registers per thread).
template <typename T>
int launch_interp_T(const void* us, const void* i0loc, const void* c0,
                    const void* w_row, const void* w_col, int B, int nbands,
                    int cap, int G2, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 1)
    return launch_interp_T_g<T, 1>(us, i0loc, c0, w_row, w_col, B, nbands,
                                   cap, G2, out, st);
  if (B == 2)
    return launch_interp_T_g<T, 2>(us, i0loc, c0, w_row, w_col, B, nbands,
                                   cap, G2, out, st);
  if (B <= 4 || sizeof(T) == 8)
    return launch_interp_T_g<T, 4>(us, i0loc, c0, w_row, w_col, B, nbands,
                                   cap, G2, out, st);
  return launch_interp_T_g<T, 8>(us, i0loc, c0, w_row, w_col, B, nbands,
                                 cap, G2, out, st);
}

template <typename T>
int launch_interp(const void* vs, long long s_batch, long long s_band,
                  long long s_row, const void* i0loc, const void* c0,
                  const void* w_row, const void* w_col, int B, int nbands,
                  int cap, int rows, int G2, void* out, void* stream) {
  const dim3 grid((cap + F_THREADS - 1) / F_THREADS, nbands,
                  (B + F_BATCH - 1) / F_BATCH);
  interp_kernel<T><<<grid, F_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)vs, s_batch, s_band, s_row, (const int*)i0loc,
      (const int*)c0, (const T*)w_row, (const T*)w_col, B, nbands, cap, rows,
      G2, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gpq_interp_T_2d_f32(const void* us, const void* i0loc, const void* c0,
                        const void* w_row, const void* w_col, int B,
                        int nbands, int cap, int G2, void* out,
                        void* stream) {
  return launch_interp_T<float>(us, i0loc, c0, w_row, w_col, B, nbands, cap,
                                G2, out, stream);
}

int gpq_interp_T_2d_f64(const void* us, const void* i0loc, const void* c0,
                        const void* w_row, const void* w_col, int B,
                        int nbands, int cap, int G2, void* out,
                        void* stream) {
  return launch_interp_T<double>(us, i0loc, c0, w_row, w_col, B, nbands, cap,
                                 G2, out, stream);
}

int gpq_interp_2d_f32(const void* vs, long long s_batch, long long s_band,
                      long long s_row, const void* i0loc, const void* c0,
                      const void* w_row, const void* w_col, int B, int nbands,
                      int cap, int rows, int G2, void* out, void* stream) {
  return launch_interp<float>(vs, s_batch, s_band, s_row, i0loc, c0, w_row,
                              w_col, B, nbands, cap, rows, G2, out, stream);
}

int gpq_interp_2d_f64(const void* vs, long long s_batch, long long s_band,
                      long long s_row, const void* i0loc, const void* c0,
                      const void* w_row, const void* w_col, int B, int nbands,
                      int cap, int rows, int G2, void* out, void* stream) {
  return launch_interp<double>(vs, s_batch, s_band, s_row, i0loc, c0, w_row,
                               w_col, B, nbands, cap, rows, G2, out, stream);
}

}  // extern "C"
