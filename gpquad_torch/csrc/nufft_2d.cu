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
//  - type-2: one thread per point; the point's mode-2 phases for a tile of
//    TK modes live in registers, the f tile (TJ x TK) is staged in shared
//    memory and read as a broadcast.  Modes are tiled, so any odd mtot works.
//    fp32 on the CUDA cores.
//  - type-1, float32: a GEMM over the points on the tensor cores with a
//    3xTF32 split (nufft1_2d_tc_kernel below): 64 x 128 output tiles, the
//    points in a fixed number of groups, each group's sum taken in stages
//    (mma accumulators), runs (shared memory) and a total (the group's
//    partial); a second pass adds the groups' partials in group order.  No
//    atomics: the result is deterministic.
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
// kernels are its G = 1 instances.  A point's phases are made once per
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

#include "nufft_common.cuh"

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
// type-1 in float32 on the tensor cores.  The sum over points is a GEMM
// whose reduction axis is the points (gpquad's _type1_tiled_kernel,
// pallas_nufft.py:406-441):  out = A^T E2  with
// A[p, (b, j)] = v_b[p] e1(p, j)  and  E2[p, k] = e2(p, k),  complex, as
// four real products:
//   out_re = Ar^T Er - Ai^T Ei,   out_im = Ar^T Ei + Ai^T Er.
// Each real operand a is split into big = cvt.rna.tf32(a) and
// small = cvt.rna.tf32(a - big) (3xTF32), and each real product is taken as
// small*big + big*small + big*big on mma.sync.m16n8k8 TF32 fragments.  A tf32
// product is exact in fp32; what is left of a is ~2^-22 of it.
//
// Block: 512 threads in four warpgroups over a TC_ROWS x COLS output
// tile: rows are G vectors x TC_ROWS / G modes j (G = 1 for the single
// kernel, 2 for the batch: the group shares every e2 tile), columns COLS
// modes k (128, or 32 where mtot is small and a wide tile would be mostly
// padding).  Grid: (row tiles x column tiles, point groups, batch groups).
// The warpgroups are specialised, so that the phases (CUDA cores) and the
// products (tensor cores) of successive stages overlap:
//  - two producer warpgroups make, per stage of TC_P points, the points'
//    torus coordinates and values, then v*e1 and e2, once into a
//    shared-memory stage buffer (phases from nufft_common.cuh, the
//    rounding of t = x*h as the other d=2 kernels carry it); each producer
//    thread keeps one mode j and one mode k for the whole run; they give
//    their registers to the consumers (setmaxnreg: 72 a thread); they
//    also split v e1 (the A operand, which four consumer warps read), so
//    that each value is split once;
//  - two consumer warpgroups, 8 warps in a 2 x 4 grid of 32 x 32 warp
//    tiles (COLS 128) or a 4 x 2 grid of 16 x 16 (COLS 32) (setmaxnreg:
//    184 a thread, for up to 64 sums, 32 mma accumulators and the
//    fragments), run the stage's TC_P / 8 k-steps; each splits its own e2
//    fragments.
// Two stage buffers; named barriers hand each one over (full: producers
// arrive, consumers wait; empty: the reverse).
//
// The sum, in a fixed order and with no atomics:
//  - a k-step's 8 points in the mma accumulators, one chain of six mma
//    started from zero: Hopper's tensor cores do not round their fp32 sums
//    to nearest, and a longer chain biases the sum towards zero (sums of
//    32 and 64 points there put 5e-3 and 1e-2 on the headline f32
//    gradient's signal-variance component, chip_smoke.py phase 4);
//  - the k-steps of `acc` points added in fp32 registers;
//  - those sums of a run of `run` points added in fp32 in shared memory
//    (each consumer thread its own sums);
//  - the runs of the block's point group added into the group's partial
//    in device memory (each thread reading back only what it wrote);
//  - launch_reduce adds the groups' partials in group order.
// Within a k-step and a pair of n-tiles each of the three passes runs over
// 8 chains, so consecutive mma do not wait on each other.
//
// The caller owns the geometry (ops/cuda_nufft.py type1_2d_geometry): it
// passes the tile (rows, cols), the batch group, `acc`, `run` and the
// points of a group (`chunk`), and the launch refuses a geometry it has no
// instance for.  The wrapper picks the group size (a multiple of `run`)
// so that tiles x groups fill the 132 SMs about four times: the scratch
// holds groups x B x mtot^2 values, not one partial per 2048-point chunk.
//
// Bound: 3 x 8 flops per point, output and vector on the tensor cores
// (495 TFLOP/s dense TF32), the phases a share of (TJ + COLS) /
// (TJ x COLS) of them on the CUDA cores.
// ---------------------------------------------------------------------------
constexpr int TC_THREADS = 512;
constexpr int TC_CONSUMERS = 256;      // warpgroups 0-1; 2-3 produce
constexpr int TC_BAR_FULL = 1;         // named barriers 1-2: stage full
constexpr int TC_BAR_EMPTY = 3;        // 3-4: stage empty
constexpr int TC_BAR_POINTS = 5;       // 5: the producers' point data
constexpr int TC_ROWS = 64;
constexpr int TC_P = 32;               // points a stage buffer
constexpr int TC_RS = TC_ROWS + 8;   // padded strides: a fragment load
                                     // reads 32 distinct banks

// The consumers' warp grid over a TC_ROWS x COLS tile: WR x WC warps of
// MI 16-row m-tiles by NI 8-column n-tiles; E sums a consumer thread.
template <int COLS>
struct TcTile {
  static_assert(COLS == 32 || COLS == 128, "tile widths: 32, 128");
  static constexpr int WC = COLS == 128 ? 4 : 2;
  static constexpr int WR = TC_CONSUMERS / 32 / WC;
  static constexpr int WM = TC_ROWS / WR, WN = COLS / WC;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int E = MI * NI * 8;
  static constexpr int CS = COLS + 8;
};

template <int COLS>
struct TcStage {
  unsigned a_s[4][TC_P][TC_RS];   // v e1, point-major, split by the
                                  // producers: Re big, Re small, Im big,
                                  // Im small (tf32 bit patterns)
  float bre[TC_P][TcTile<COLS>::CS];   // Re(e2)
  float bim[TC_P][TcTile<COLS>::CS];
  float u1[TC_P], u2[TC_P]; // the points' t = x h on the torus
  float2 vq[2][TC_P];       // the values of up to two vectors
};

__device__ __forceinline__ unsigned tf32_rna(float a) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// a -> (big, small), both tf32 bit patterns
__device__ __forceinline__ void split3(float a, unsigned* big,
                                       unsigned* small) {
  *big = tf32_rna(a);
  *small = tf32_rna(a - __uint_as_float(*big));
}

// d += A (16x8, row) * B (8x8, col) on the tensor cores, TF32 in, fp32 out
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(TC_THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(TC_THREADS) : "memory");
}

// Producer thread ptid always makes the same mode j (column a = ptid % TJ
// of v e1) and the same mode k (column b = ptid % COLS of e2), for the
// stage's points ptid / TJ + i NP / TJ and ptid / COLS + i NP / COLS.
template <int G, int COLS>
struct TcModes {
  float k1, k2;       // mode values; 0 past m
  bool ok1, ok2;      // mode inside the grid
  __device__ TcModes(int ptid, int m, int fft_order, int j0, int k0) {
    constexpr int TJ = TC_ROWS / G;
    const int j = j0 + ptid % TJ, k = k0 + ptid % COLS;
    ok1 = j < m;
    ok2 = k < m;
    k1 = ok1 ? mode_value<float>(j, m, fft_order) : 0.f;
    k2 = ok2 ? mode_value<float>(k, m, fft_order) : 0.f;
  }
};

// One stage: the points p0.. up to p_end (t = x h folded onto the torus,
// once per point, and the values), then v e1 for G vectors x TJ modes and
// e2 for COLS modes (zero past m; a point past p_end has zero values, so
// its products vanish)
template <int G, int COLS>
__device__ __forceinline__ void tc_fill(TcStage<COLS>& st, int ptid,
                                        const TcModes<G, COLS>& md,
                                        const float2* __restrict__ x,
                                        const float2* __restrict__ v,
                                        float h, int n, int b0, int gn,
                                        int p0, int p_end) {
  constexpr int TJ = TC_ROWS / G;
  constexpr int NP = TC_THREADS - TC_CONSUMERS;
  if (ptid < TC_P) {
    const int p = p0 + ptid;
    const bool ok = p < p_end;
    float2 xp = make_float2(0.f, 0.f);
    if (ok) xp = x[p];
    st.u1[ptid] = torus(xp.x, h);
    st.u2[ptid] = torus(xp.y, h);
#pragma unroll
    for (int g = 0; g < G; ++g)
      st.vq[g][ptid] = ok && g < gn ? v[(size_t)(b0 + g) * n + p]
                                    : make_float2(0.f, 0.f);
  }
  asm volatile("bar.sync %0, %1;" ::"n"(TC_BAR_POINTS), "n"(NP) : "memory");
  const int a = ptid % TJ, b = ptid % COLS;
#pragma unroll
  for (int it = 0; it < TC_P * TJ / NP; ++it) {
    const int q = ptid / TJ + it * (NP / TJ);
    float c = 0.f, sn = 0.f;
    if (md.ok1) phase(st.u1[q], md.k1, &c, &sn);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float2 vq = st.vq[g][q];
      // (c - i s)(vr + i vi)
      unsigned* o = &st.a_s[0][q][g * TJ + a];
      constexpr int PLANE = TC_P * TC_RS;
      split3(fmaf(c, vq.x, sn * vq.y), &o[0], &o[PLANE]);
      split3(fmaf(c, vq.y, -sn * vq.x), &o[2 * PLANE], &o[3 * PLANE]);
    }
  }
#pragma unroll
  for (int it = 0; it < TC_P * COLS / NP; ++it) {
    const int q = ptid / COLS + it * (NP / COLS);
    float c = 0.f, sn = 0.f;
    if (md.ok2) phase(st.u2[q], md.k2, &c, &sn);
    st.bre[q][b] = c;
    st.bim[q][b] = -sn;
  }
}

template <int G, int COLS>
__global__ void __launch_bounds__(TC_THREADS, 1)
nufft1_2d_tc_kernel(const float2* __restrict__ x,
                    const float2* __restrict__ v, float h, int n, int m,
                    int nb, int fft_order, int acc_points, int run_points,
                    int chunk, float2* __restrict__ partial) {
  using Tile = TcTile<COLS>;
  constexpr int TJ = TC_ROWS / G;
  constexpr int MI = Tile::MI, NI = Tile::NI, E = Tile::E;
  extern __shared__ float4 tc_smem[];
  TcStage<COLS>* stages = reinterpret_cast<TcStage<COLS>*>(tc_smem);
  const int ntk = (m + COLS - 1) / COLS;
  const int j0 = (blockIdx.x / ntk) * TJ;
  const int k0 = (blockIdx.x % ntk) * COLS;
  const int b0 = blockIdx.z * G;
  const int gn = min(G, nb - b0);
  const int p_begin = blockIdx.y * chunk;
  const int p_end = min(n, p_begin + chunk);
  const int tid = threadIdx.x;

  if (tid >= TC_CONSUMERS) {
    // producers: fill stage s into buffer s & 1 once the consumers are done
    // with stage s - 2; at the end take the consumers' last two releases
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::);
    const int ptid = tid - TC_CONSUMERS;
    const TcModes<G, COLS> md(ptid, m, fft_order, j0, k0);
    int s = 0;
    for (int r0 = p_begin; r0 < p_end; r0 += run_points) {
      const int r_end = min(p_end, r0 + run_points);
      for (int p0 = r0; p0 < r_end; p0 += TC_P, ++s) {
        if (s >= 2) bar_sync(TC_BAR_EMPTY + (s & 1));
        tc_fill<G, COLS>(stages[s & 1], ptid, md, x, v, h, n, b0, gn, p0,
                         r_end);
        bar_arrive(TC_BAR_FULL + (s & 1));
      }
    }
    for (int t = max(s - 2, 0); t < s; ++t) bar_sync(TC_BAR_EMPTY + (t & 1));
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n" ::);
  // the run sums: element e of consumer thread t at run[e][t]
  float (*run)[TC_CONSUMERS] =
      reinterpret_cast<float (*)[TC_CONSUMERS]>(stages + 2);
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;     // fragment row / column
  const int wr = (warp / Tile::WC) * Tile::WM;
  const int wc = (warp % Tile::WC) * Tile::WN;

  int s = 0;
  float acc[MI][NI][8];   // sums of acc_points points: [m][n][re 4, im 4]
  for (int r0 = p_begin; r0 < p_end; r0 += run_points) {
    const int r_end = min(p_end, r0 + run_points);
#pragma unroll
    for (int e = 0; e < E; ++e) run[e][tid] = 0.f;
    for (int p0 = r0; p0 < r_end; p0 += TC_P, ++s) {
      bar_sync(TC_BAR_FULL + (s & 1));
      const TcStage<COLS>& st = stages[s & 1];
      // acc_points points (a whole number of stages) in acc
      const bool open = (p0 - r0) % acc_points == 0;
      const bool close = (p0 - r0) % acc_points + TC_P == acc_points ||
                         p0 + TC_P >= r_end;
      if (open) {
#pragma unroll
        for (int a = 0; a < MI; ++a)
#pragma unroll
          for (int b = 0; b < NI; ++b)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[a][b][c] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < TC_P; ks += 8) {
        // A fragments of the warp's two m-tiles: a0 (g, t), a1 (g+8, t),
        // a2 (g, t+4), a3 (g+8, t+4); rows are output rows, columns points.
        // [split][m-tile][reg], split 0 big, 1 small
        unsigned ar[2][MI][4], ai[2][MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int r = wr + mi * 16 + gq;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = ks + tq + (i >> 1) * 4;
            const int rr = r + (i & 1) * 8;
            ar[0][mi][i] = st.a_s[0][q][rr];
            ar[1][mi][i] = st.a_s[1][q][rr];
            ai[0][mi][i] = st.a_s[2][q][rr];
            ai[1][mi][i] = st.a_s[3][q][rr];
          }
        }
        // two n-tiles at a time: their B fragments (b0 (t, g), b1 (t+4, g);
        // rows points, columns modes; [split][n-tile][reg]) and the
        // k-step's sums, one chain of six mma per accumulator started from
        // zero, then added into acc
#pragma unroll
        for (int nh = 0; nh < NI; nh += 2) {
          unsigned br[2][2][2], bi[2][2][2];
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const int cidx = wc + (nh + nn) * 8 + gq;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int q = ks + tq + i * 4;
              split3(st.bre[q][cidx], &br[0][nn][i], &br[1][nn][i]);
              split3(st.bim[q][cidx], &bi[0][nn][i], &bi[1][nn][i]);
            }
          }
          float d[MI][2][8];
#pragma unroll
          for (int a = 0; a < MI; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
              for (int c = 0; c < 8; ++c) d[a][b][c] = 0.f;
          // small*big, big*small, big*big; Re += Ar Er + Ai (-Ei),
          // Im += Ar Ei + Ai Er.  Each pass runs over all 8 chains, so
          // consecutive mma do not wait on each other.
#pragma unroll
          for (int pass = 0; pass < 3; ++pass) {
            const int sa = pass == 0 ? 1 : 0;     // A's split
            const int sb = pass == 1 ? 1 : 0;     // B's split
#pragma unroll
            for (int nn = 0; nn < 2; ++nn)
#pragma unroll
              for (int mi = 0; mi < MI; ++mi) {
                mma_tf32(&d[mi][nn][0], ar[sa][mi], br[sb][nn]);
                mma_tf32(&d[mi][nn][4], ar[sa][mi], bi[sb][nn]);
              }
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
              const unsigned nbi[2] = {bi[sb][nn][0] ^ 0x80000000u,
                                       bi[sb][nn][1] ^ 0x80000000u};
#pragma unroll
              for (int mi = 0; mi < MI; ++mi) {
                mma_tf32(&d[mi][nn][0], ai[sa][mi], nbi);
                mma_tf32(&d[mi][nn][4], ai[sa][mi], br[sb][nn]);
              }
            }
          }
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int nn = 0; nn < 2; ++nn)
#pragma unroll
              for (int c = 0; c < 8; ++c)
                acc[mi][nh + nn][c] = __fadd_rn(acc[mi][nh + nn][c],
                                                d[mi][nn][c]);
        }
      }
      bar_arrive(TC_BAR_EMPTY + (s & 1));
      if (!close) continue;
      // the accumulated sums into the run's, in order
#pragma unroll
      for (int a = 0; a < MI; ++a)
#pragma unroll
        for (int b = 0; b < NI; ++b)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int e = (a * NI + b) * 8 + c;
            run[e][tid] = __fadd_rn(run[e][tid], acc[a][b][c]);
          }
    }
    // the run's sums into the group's partial, in run order (each thread
    // reads back only what it wrote)
    const bool first = r0 == p_begin;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // C fragment: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
          const int row = wr + mi * 16 + gq + (i >> 1) * 8;
          const int g = row / TJ, j = j0 + row % TJ;
          const int k = k0 + wc + ni * 8 + 2 * tq + (i & 1);
          if (g < gn && j < m && k < m) {
            const int e = (mi * NI + ni) * 8 + i;
            float2* o = partial +
                (((size_t)blockIdx.y * nb + b0 + g) * m + j) * m + k;
            float2 t = first ? make_float2(0.f, 0.f) : *o;
            t.x = __fadd_rn(t.x, run[e][tid]);
            t.y = __fadd_rn(t.y, run[e + 4][tid]);
            *o = t;
          }
        }
  }
}

// The single kernels are the G = 1 instances (the single type-2 with 64
// threads per block); a batch runs in groups of 4 (type-2, 128 threads) or
// 8 (the float64 type-1) vectors, and the float32 type-1 on the tensor
// cores in groups of 2.
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

// float32 type-1 on the tensor cores: `chunk` points a group, one partial
// per group
template <int G, int COLS>
int launch_nufft1_tc_cols(const void* x, const void* v, float h, int n,
                          int m, int nb, int fft_order, int acc, int run,
                          int chunk, void* partial, void* out,
                          cudaStream_t s) {
  constexpr int TJ = TC_ROWS / G;
  constexpr int smem =
      2 * sizeof(TcStage<COLS>) + TcTile<COLS>::E * TC_CONSUMERS * 4;
  int err = (int)cudaFuncSetAttribute(
      nufft1_2d_tc_kernel<G, COLS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const int ntj = (m + TJ - 1) / TJ, ntk = (m + COLS - 1) / COLS;
  const int groups = (n + chunk - 1) / chunk;
  const dim3 grid(ntj * ntk, groups, (nb + G - 1) / G);
  nufft1_2d_tc_kernel<G, COLS><<<grid, TC_THREADS, smem, s>>>(
      (const float2*)x, (const float2*)v, h, n, m, nb, fft_order, acc, run,
      chunk, (float2*)partial);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_reduce<float>(partial, groups, nb * m * m, out, s);
}

// The caller's geometry (rows x cols tile, batch group, points a register
// sum, a run and a group), checked against the instances there are
template <int G>
int launch_nufft1_tc(const void* x, const void* v, float h, int n, int m,
                     int nb, int fft_order, int rows, int cols, int group,
                     int acc, int run, int chunk, void* partial, void* out,
                     void* stream) {
  if (rows != TC_ROWS || group != G || acc <= 0 || acc % TC_P != 0 ||
      run % acc != 0 || chunk <= 0 || chunk % run != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cols == 32)
    return launch_nufft1_tc_cols<G, 32>(x, v, h, n, m, nb, fft_order, acc,
                                        run, chunk, partial, out, s);
  if (cols == 128)
    return launch_nufft1_tc_cols<G, 128>(x, v, h, n, m, nb, fft_order, acc,
                                         run, chunk, partial, out, s);
  return (int)cudaErrorInvalidValue;
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

int gpq_nufft1_2d_f32(const void* x, const void* v, float h, int n, int m,
                      int fft_order, int rows, int cols, int group, int acc,
                      int run, int chunk, void* partial, void* out,
                      void* stream) {
  return launch_nufft1_tc<1>(x, v, h, n, m, 1, fft_order, rows, cols, group,
                             acc, run, chunk, partial, out, stream);
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
  return launch_nufft1_tc<TCB_GROUP>(x, v, h, n, m, nb, fft_order, rows,
                                     cols, group, acc, run, chunk, partial,
                                     out, stream);
}

int gpq_nufft1_2d_batched_f64(const void* x, const void* v, double h, int n,
                              int m, int nb, int fft_order, int chunk,
                              void* partial, void* out, void* stream) {
  return launch_nufft1<double, T1B_GROUP>(x, v, h, n, m, nb, fft_order, chunk,
                                          partial, out, stream);
}

}  // extern "C"
