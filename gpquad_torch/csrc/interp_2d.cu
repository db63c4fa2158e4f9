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
// interp_T: one block per (band, 64-column tile, group of BB vectors); one
// thread per slab column holds that column's (bh+3) x BB sums in registers.
// A column meets only the ~(4 cap / G2) slots whose stencil columns
// c0..c0+3 cover it, so the host plan builds, per band, the valid slots
// sorted stably by c0 (col_slots) and the CSR of where each c0 starts
// (col_start; ops/cuda_interp.py column_index): column c owns the contiguous
// range col_start[max(c-3, 0)] .. col_start[c+1].  A block stages only its
// tile's range, from col_start[t0-3] to col_start[t0+64] (clamped at the
// slab's edges), through shared memory, its tables gathered through the
// index; each thread then walks its own column's range and adds each
// slot's contributions.  The walk is what takes the time (each thread's
// slots one after another): 64-column tiles give twice the blocks of
// 128-column ones, and their range (~400 slots at phase 11's plan) is one
// staged chunk.  Padded slots are not in the index.  So each cell's
// sum is taken in one fixed order (by c0, then slot order), with no atomics
// and with no fused multiply-add (the plain twin interp_T_2d_sorted_ref
// repeats it bit for bit), and the result does not change from run to run
// (an unordered float atomic would move CG iteration counts between runs).
// Every cell is bound-checked: a slot's columns and rows outside the slab
// are skipped.
//
// interp: one thread per slot, looping over a group of vectors; each reads
// its 4x4 stencil from the band's slab.  The slab input is a strided view
// (batch, band, row strides given; columns contiguous), so the caller passes
// an overlapping view of the padded grid instead of a gathered copy.  Slots
// whose stencil leaves the slab (padded slots) sum only the cells inside it:
// their values are not read back.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// four weights of a slot (the tables are 16-byte aligned per slot in float32
// and 32-byte in float64: the wrapper checks)
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = a.z;
  o[3] = a.w;
}

__device__ __forceinline__ void load4(const double* p, double* o) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

constexpr int T_COLS = 64;      // slab columns per interp_T block
constexpr int T_CHUNK = 512;    // indexed slots staged per step (f32)
constexpr int T_ROWS = 11;      // slab height bh + 3 at the plan's bh = 8
constexpr int F_THREADS = 256;  // slots per interp block
constexpr int F_BATCH = 16;     // vectors per interp block

template <typename T, int BB>
__global__ void __launch_bounds__(T_COLS)
interp_T_kernel(const T* __restrict__ us, const int* __restrict__ i0loc,
                const int* __restrict__ c0, const T* __restrict__ w_row,
                const T* __restrict__ w_col, const int* __restrict__ col_slots,
                const int* __restrict__ col_start, int B, int nbands, int cap,
                int G2, T* __restrict__ out) {
  constexpr int CH = sizeof(T) == 4 ? T_CHUNK : T_CHUNK / 2;
  __shared__ int s_i0[CH];
  __shared__ int s_c0[CH];
  __shared__ T s_wr[CH][4];
  __shared__ T s_wc[CH][4];
  __shared__ T s_u[BB][CH];

  const int band = blockIdx.x;
  const int t0 = blockIdx.y * T_COLS;
  const int col = t0 + threadIdx.x;
  const int b0 = blockIdx.z * BB;
  const int nb = min(BB, B - b0);
  const int* cs = col_start + (size_t)band * (G2 + 1);
  const int* sl = col_slots + (size_t)band * cap;
  // the tile's slots, c0 in [t0 - 3, t0 + T_COLS - 1], and the column's own
  const int lo = cs[max(t0 - 3, 0)];
  const int hi = cs[min(t0 + T_COLS, G2)];
  const int my_lo = col < G2 ? cs[max(col - 3, 0)] : 0;
  const int my_hi = col < G2 ? cs[col + 1] : 0;

  T acc[T_ROWS][BB];
#pragma unroll
  for (int r = 0; r < T_ROWS; ++r)
#pragma unroll
    for (int b = 0; b < BB; ++b) acc[r][b] = T(0);

  for (int s0 = lo; s0 < hi; s0 += CH) {
    const int cnt = min(CH, hi - s0);
    __syncthreads();
    // the chunk's slot numbers first, then their tables (a gather through
    // the index: all of a thread's loads in flight at once, the weights as
    // 16- or 32-byte vectors)
    int ps[CH / T_COLS];
#pragma unroll
    for (int k = 0; k < CH / T_COLS; ++k) {
      const int i = threadIdx.x + k * T_COLS;
      ps[k] = i < cnt ? sl[s0 + i] : -1;
    }
#pragma unroll
    for (int k = 0; k < CH / T_COLS; ++k) {
      const int i = threadIdx.x + k * T_COLS;
      if (ps[k] < 0) continue;
      const size_t slot = (size_t)band * cap + ps[k];
      s_i0[i] = i0loc[slot];
      s_c0[i] = c0[slot];
      load4(w_row + slot * 4, s_wr[i]);
      load4(w_col + slot * 4, s_wc[i]);
#pragma unroll
      for (int b = 0; b < BB; ++b)
        s_u[b][i] = b < nb
            ? us[((size_t)(b0 + b) * nbands + band) * cap + ps[k]] : T(0);
    }
    __syncthreads();
    const int e = min(my_hi, s0 + cnt) - s0;
    for (int i = max(my_lo, s0) - s0; i < e; ++i) {
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
          for (int b = 0; b < BB; ++b)
            acc[r][b] = add_rn(acc[r][b], mul_rn(mul_rn(wr, u[b]), wc));
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
                      const void* w_row, const void* w_col,
                      const void* col_slots, const void* col_start, int B,
                      int nbands, int cap, int G2, void* out,
                      cudaStream_t st) {
  const dim3 grid(nbands, (G2 + T_COLS - 1) / T_COLS, (B + BB - 1) / BB);
  interp_T_kernel<T, BB><<<grid, T_COLS, 0, st>>>(
      (const T*)us, (const int*)i0loc, (const int*)c0, (const T*)w_row,
      (const T*)w_col, (const int*)col_slots, (const int*)col_start, B,
      nbands, cap, G2, (T*)out);
  return (int)cudaGetLastError();
}

// Batch groups: the whole batch when it is small, else groups of 8 vectors
// in float32 and 4 in float64 (11 x BB sums in registers per thread).
template <typename T>
int launch_interp_T(const void* us, const void* i0loc, const void* c0,
                    const void* w_row, const void* w_col,
                    const void* col_slots, const void* col_start, int B,
                    int nbands, int cap, int G2, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B == 1)
    return launch_interp_T_g<T, 1>(us, i0loc, c0, w_row, w_col, col_slots,
                                   col_start, B, nbands, cap, G2, out, st);
  if (B == 2)
    return launch_interp_T_g<T, 2>(us, i0loc, c0, w_row, w_col, col_slots,
                                   col_start, B, nbands, cap, G2, out, st);
  if (B <= 4 || sizeof(T) == 8)
    return launch_interp_T_g<T, 4>(us, i0loc, c0, w_row, w_col, col_slots,
                                   col_start, B, nbands, cap, G2, out, st);
  return launch_interp_T_g<T, 8>(us, i0loc, c0, w_row, w_col, col_slots,
                                 col_start, B, nbands, cap, G2, out, st);
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
                        const void* w_row, const void* w_col,
                        const void* col_slots, const void* col_start, int B,
                        int nbands, int cap, int G2, void* out,
                        void* stream) {
  return launch_interp_T<float>(us, i0loc, c0, w_row, w_col, col_slots,
                                col_start, B, nbands, cap, G2, out, stream);
}

int gpq_interp_T_2d_f64(const void* us, const void* i0loc, const void* c0,
                        const void* w_row, const void* w_col,
                        const void* col_slots, const void* col_start, int B,
                        int nbands, int cap, int G2, void* out,
                        void* stream) {
  return launch_interp_T<double>(us, i0loc, c0, w_row, w_col, col_slots,
                                 col_start, B, nbands, cap, G2, out, stream);
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
