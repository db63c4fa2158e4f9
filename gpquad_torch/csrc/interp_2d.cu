// Hand-written CUDA kernels for SKI's d=2 cubic interpolation (4x4 stencils)
// on the band plan of gpquad_torch/models/ski.py.
//
// interp_T_2d replaces gpquad/ops/pallas_interp.py pallas_interp_T_2d (:104):
// the band slabs of W^T u (points -> grid).  interp_2d replaces
// pallas_interp_2d (:237) and the gather around it (gpquad/models/ski.py
// SKIOperator._interp_banded_pallas): W v (grid -> points) in point order,
// or at the band-sorted slots.  The TPU kernels build one-hot row and column selectors to feed
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
// interp: one launch from the grid to the points.  A block takes one band,
// a chunk of its slots (4 a thread in float32, 2 in float64) and a group of
// up to 4 vectors; each thread reads its slots' tables once and keeps them
// in registers for every vector of the group.  Per vector the block copies
// the band's slab (its bh + 3 grid rows) into shared memory with cp.async,
// the next vector's while this one's sums are taken, and each thread sums
// its slots' 4x4 stencils from there, rows first, then columns (the TPU
// kernel's order), with no fused multiply-add, so that the plain twin
// (ops/cuda_interp.py interp_2d_points_ref) repeats it bit for bit.  With
// the plan's point-of-slot table (pout) the sums go straight to point
// order, out[b, pout[slot]], for the valid slots only: no slot-order
// buffer, no transpose and no gather behind it, and grid rows past G1 read
// as zero, so no padded copy of the grid before it.  Without it (the
// band-slot API, held against pallas_interp_2d) the same kernel writes
// every slot in band-slot order from a strided slab view.  Cells outside
// the slab are skipped, so padded slots with any tables stay finite.  The
// bound counts bytes (each valid slot's ~44 bytes of tables, the grid once
// and the points once), but the points are written in the user's order,
// one 4-byte store in a sector of its own each: those writes alone take
// ~80% of the kernel's time (scripts/time_interp_2d.py).  Slot order keeps
// a warp's points, which the plan lists ascending, near each other.  The
// script times this shape beside others (2048 slots a block, 128 or 512
// threads, groups of 1 or 16 vectors, three blocks an SM).
#include <cuda_runtime.h>

#include <cstdint>

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
constexpr int F_THREADS = 256;  // threads an interp block
// slots a thread (chunks of 1024 slots in float32, 512 in float64, whose
// tables take twice the registers)
template <typename T>
constexpr int F_SLOTS = sizeof(T) == 4 ? 4 : 2;
constexpr int F_BATCH = 4;      // vectors an interp block
constexpr int F_BH = 8;         // band height bh (the plan's)
constexpr int F_ROWS = F_BH + 3;   // slab rows
constexpr int F_TILE_BYTES = 4096; // widest staged row: 1024 floats

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

// cp.async of one element (4 or 8 bytes) or of 16 bytes, global -> shared
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(sa),
                 "l"(gmem), "n"(BYTES));
}

// Start the copy of one slab into shared memory: the band's rows (F_ROWS
// of them, rows at or past `rows` zero) of vector gb, columns t0 .. t0 +
// wt; 16-byte copies where the grid's
// rows are aligned (vec), else one element each (any column stride, e.g.
// the real part of a complex grid).
template <typename T>
__device__ __forceinline__ void stage_slab(T* slab, int rs, const T* gb,
                                           long long s_row, long long s_col,
                                           int rows, int t0, int wt,
                                           bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int wv = wt / V;
    for (int e = threadIdx.x; e < F_ROWS * wv; e += F_THREADS) {
      const int r = e / wv, c = e - r * wv;
      T* dst = slab + r * rs + c * V;
      if (r < rows)
        cp_async<16>(dst, gb + r * s_row + t0 + c * V);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < F_ROWS * wt; e += F_THREADS) {
      const int r = e / wt, c = e - r * wt;
      if (r < rows)
        cp_async<sizeof(T)>(slab + r * rs + c,
                            gb + r * s_row + (t0 + c) * s_col);
      else
        slab[r * rs + c] = T(0);
    }
  }
}

// The sum of one slot: acc += sum_jc (sum_jr wr[jr] slab[i0 + jr][c + jc])
// wc[jc], rows first, then columns (the TPU kernel's order), with no fused
// multiply-add, so that the plain twin repeats it bit for bit.  A stencil
// wholly inside the slab tile reads its 16 cells at fixed offsets; one on
// the slab's edge (only padded slots, and slots on a column tile's edge)
// skips the cells outside.
template <typename T>
__device__ __forceinline__ T slot_sum(T acc, const T* slab, int rs, int i0,
                                      int c, int wt, const T* wr,
                                      const T* wc) {
  if (i0 >= 0 && i0 <= F_ROWS - 4 && c >= 0 && c <= wt - 4) {
    const T* sp = slab + i0 * rs + c;
#pragma unroll
    for (int jc = 0; jc < 4; ++jc) {
      T inner = T(0);
#pragma unroll
      for (int jr = 0; jr < 4; ++jr)
        inner = add_rn(inner, mul_rn(wr[jr], sp[jr * rs + jc]));
      acc = add_rn(acc, mul_rn(inner, wc[jc]));
    }
    return acc;
  }
#pragma unroll
  for (int jc = 0; jc < 4; ++jc) {
    if ((unsigned)(c + jc) >= (unsigned)wt) continue;
    T inner = T(0);
#pragma unroll
    for (int jr = 0; jr < 4; ++jr)
      if ((unsigned)(i0 + jr) < (unsigned)F_ROWS)
        inner = add_rn(inner,
                       mul_rn(wr[jr], slab[(i0 + jr) * rs + c + jc]));
    acc = add_rn(acc, mul_rn(inner, wc[jc]));
  }
  return acc;
}

// One interp block: F_THREADS threads x S slots of one band, a chunk of
// S * F_THREADS consecutive slots, and a group of up to F_BATCH vectors,
// walking its steps (vector, column tile) with two slab buffers.  A block
// whose chunk holds no live slot leaves before it copies anything.
//
// Output: with pout (point order), out[b, pout[slot]] for the valid slots
// (pout >= 0); without, band-slot order, out[band, b, p] for every slot.
// The grid element (b, band, r, c) is at g + b s_batch + band s_band +
// r s_row + c s_col.
template <typename T>
__global__ void __launch_bounds__(F_THREADS, 2)
interp_kernel(const T* __restrict__ g, long long s_batch, long long s_band,
              long long s_row, long long s_col, int g_rows, int vec,
              const int* __restrict__ i0loc, const int* __restrict__ c0,
              const T* __restrict__ w_row, const T* __restrict__ w_col,
              const int* __restrict__ pout, int B, int nbands, int cap,
              int G2, int n, int tw, T* __restrict__ out) {
  constexpr int S = F_SLOTS<T>;
  extern __shared__ float4 f_smem[];
  const int rs = tw + 16 / (int)sizeof(T);   // 16-byte aligned rows
  T* const slabs = reinterpret_cast<T*>(f_smem);   // two buffers
  const int band = blockIdx.y;
  int dst[S];
  bool any = false;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int p = (blockIdx.x * S + k) * F_THREADS + threadIdx.x;
    dst[k] = -1;
    if (p < cap) dst[k] = pout ? pout[(size_t)band * cap + p] : p;
    any |= dst[k] >= 0;
  }
  if (!__syncthreads_or(any)) return;
  const int b_begin = blockIdx.z * F_BATCH;
  const int ntile = (G2 + tw - 1) / tw;
  const int nsteps = (min(B, b_begin + F_BATCH) - b_begin) * ntile;
  // slab rows holding grid data (the rest read as zero)
  const int rows = min(F_ROWS, g_rows - band * F_BH);
  auto stage = [&](int s) {
    const int t0 = (s % ntile) * tw;
    stage_slab(slabs + (s & 1) * F_ROWS * rs, rs,
               g + (b_begin + s / ntile) * s_batch + band * s_band, s_row,
               s_col, rows, t0, min(tw, G2 - t0), vec != 0);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0);
  int i0[S], cc[S];
  T wr[S][4], wc[S][4];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const size_t slot =
        (size_t)band * cap + (blockIdx.x * S + k) * F_THREADS + threadIdx.x;
    i0[k] = cc[k] = 0;
    if (dst[k] >= 0) {
      i0[k] = i0loc[slot];
      cc[k] = c0[slot];
      load4(w_row + slot * 4, wr[k]);
      load4(w_col + slot * 4, wc[k]);
    }
  }
  T acc[S];
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) {
      stage(s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const T* slab = slabs + (s & 1) * F_ROWS * rs;
    const int t0 = (s % ntile) * tw;
    const int wt = min(tw, G2 - t0);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (t0 == 0) acc[k] = T(0);
      if (dst[k] >= 0)
        acc[k] = slot_sum(acc[k], slab, rs, i0[k], cc[k] - t0, wt, wr[k],
                          wc[k]);
    }
    if (t0 + wt == G2) {
      const int b = b_begin + s / ntile;
      T* o = out + (pout ? (size_t)b * n : ((size_t)band * B + b) * cap);
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (dst[k] >= 0) o[dst[k]] = acc[k];
    }
    __syncthreads();   // the buffer is refilled two steps on
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
int launch_interp(const void* g, long long s_batch, long long s_band,
                  long long s_row, long long s_col, int g_rows, int vec,
                  const void* i0loc, const void* c0, const void* w_row,
                  const void* w_col, const void* pout, int B, int nbands,
                  int cap, int G2, int n, void* out, void* stream) {
  const int tw = min(G2, F_TILE_BYTES / (int)sizeof(T));
  constexpr int V = 16 / sizeof(T);
  // the 16-byte copies need aligned rows of whole vectors
  if (vec && (s_col != 1 || G2 % V != 0 || s_row % V != 0 ||
              s_band % V != 0 || s_batch % V != 0 ||
              (uintptr_t)g % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int smem = 2 * F_ROWS * (tw + V) * (int)sizeof(T);
  int err = (int)cudaFuncSetAttribute(
      interp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const int chunk = F_THREADS * F_SLOTS<T>;
  const dim3 grid((cap + chunk - 1) / chunk, nbands,
                  (B + F_BATCH - 1) / F_BATCH);
  interp_kernel<T><<<grid, F_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)g, s_batch, s_band, s_row, s_col, g_rows, vec,
      (const int*)i0loc, (const int*)c0, (const T*)w_row, (const T*)w_col,
      (const int*)pout, B, nbands, cap, G2, n, tw, (T*)out);
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

int gpq_interp_2d_f32(const void* g, long long s_batch, long long s_band,
                      long long s_row, long long s_col, int g_rows, int vec,
                      const void* i0loc, const void* c0, const void* w_row,
                      const void* w_col, const void* pout, int B,
                      int nbands, int cap, int G2, int n, void* out,
                      void* stream) {
  return launch_interp<float>(g, s_batch, s_band, s_row, s_col, g_rows, vec,
                              i0loc, c0, w_row, w_col, pout, B, nbands, cap,
                              G2, n, out, stream);
}

int gpq_interp_2d_f64(const void* g, long long s_batch, long long s_band,
                      long long s_row, long long s_col, int g_rows, int vec,
                      const void* i0loc, const void* c0, const void* w_row,
                      const void* w_col, const void* pout, int B,
                      int nbands, int cap, int G2, int n, void* out,
                      void* stream) {
  return launch_interp<double>(g, s_batch, s_band, s_row, s_col, g_rows, vec,
                               i0loc, c0, w_row, w_col, pout, B, nbands, cap,
                               G2, n, out, stream);
}

}  // extern "C"
