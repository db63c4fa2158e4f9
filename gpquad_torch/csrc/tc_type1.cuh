// The float32 type-1 NUFFT on the tensor cores, shared by nufft_2d.cu (the
// d=2 type-1, single and batched), nufft_1d.cu (the d=1 type-1 on a split
// of its mode index) and nufft_3d.cu (the d=3 type-1): one kernel,
// type1_tc_kernel<P, G, COLS>, whose problem type P says what its rows,
// columns and stage coordinates are.
//
// The sum over points is a GEMM whose reduction axis is the points (gpquad's
// _type1_tiled_kernel, pallas_nufft.py:406-441):  out = A^T E2  with
// A[p, (b, j)] = v_b[p] e1(p, j)  and  E2[p, k] = e2(p, k),  complex
// (e = e^{-2 pi i c}), as four real products:
//   out_re = Ar^T Er - Ai^T Ei,   out_im = Ar^T Ei + Ai^T Er.
// Each real operand a is split into big = cvt.rna.tf32(a) and
// small = cvt.rna.tf32(a - big) (3xTF32), and each real product is taken as
// small*big + big*small + big*big on mma.sync.m16n8k8 TF32 fragments.  A tf32
// product is exact in fp32; what is left of a is ~2^-22 of it.
//
// The problems (P):
//  - d=2 (nufft_2d.cu Type1Grid2D): row j is mode k_j of the first axis,
//    column k mode k_k of the second, e1 and e2 the phases of x1 and x2;
//    output (j, k) of an mtot x mtot grid;
//  - d=1 (nufft_1d.cu Type1Split1D): the mode index split as k = K q + r,
//    K = TC_ROWS / G: row r in 0..K-1 with e1 = e^{-2 pi i r t}, column q
//    with e2 = e^{-2 pi i K q t}, so that e1 e2 = e^{-2 pi i k t}; each
//    point makes K + (columns) phases, not mtot; the outputs with |k| past
//    mtot's half are cropped in the epilogue;
//  - d=3 (nufft_3d.cu Type1Grid3D): the first axis's mode split as
//    k1 = S q + r, row (r, j3) with e1 = e^{-2 pi i r u1} e3(j3), column
//    (q, j2) with e2 = e^{-2 pi i S q u1} e2(j2), each the product of two
//    folded phases; output (j1, j2, j3) of the mtot^3 grid, the cells with
//    |k1| past mtot's half cropped.  A stage's e^{-2 pi i r u1}, e^{-2 pi i
//    S q u1} and e2 come from a table of the tile's (P::tab_fill), which
//    the producers make once a stage.
//
// Block: 512 threads in four warpgroups over a TC_ROWS x COLS output
// tile: rows are G vectors x TC_ROWS / G row modes (G = 1 for one vector,
// 2 for a batch: the group shares every e2 tile), columns COLS column modes
// (128, or 32 where a wide tile would be mostly padding).  Grid: (row tiles
// x column tiles, point groups, batch groups).  The warpgroups are
// specialised, so that the phases (CUDA cores) and the products (tensor
// cores) of successive stages overlap:
//  - two producer warpgroups make, per stage of TC_P points, the points'
//    stage coordinates (P::point: at d=2 and d=3 the torus coordinates, at
//    d=1 the torus coordinate and the rounding error of t = x*h) and
//    values, P's table where it has one (P::tab_fill), then v*e1 and e2,
//    once into a shared-memory stage buffer (phases from
//    nufft_common.cuh: P::row_phase, P::col_phase); each producer thread
//    keeps one row mode and one column mode for the whole run; they give
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
//  - launch_reduce adds the groups' partials in group order, in P::Acc
//    (float at d=2 and d=3; double at d=1, whose sorted time series keep
//    the groups' partials large at the low modes).
// Within a k-step and a pair of n-tiles each of the three passes runs over
// 8 chains, so consecutive mma do not wait on each other.
//
// The caller owns the geometry (ops/cuda_nufft.py type1_2d_geometry,
// type1_1d_geometry, type1_3d_geometry): it passes the tile (rows, cols),
// the batch group, `acc`, `run` and the points of a group (`chunk`), and
// the launch refuses a geometry it has no instance for.  The wrapper picks
// the group size (a multiple of `run`) so that tiles x groups fill the 132
// SMs about four times: the scratch holds groups x B x outputs values.
//
// Bound: 3 x 8 flops per point, output and vector on the tensor cores
// (495 TFLOP/s dense TF32), the phases a share of (TJ + COLS) /
// (TJ x COLS) of them on the CUDA cores.
//
// The problem type P provides: X, the point's type in x; point(x, h, &a,
// &b, &c), its stage coordinates; Row and Col, what a producer keeps of
// its row's and its column's mode (a mode value, or at d=3 places in the
// table and a mode value); row_mode<TJ>(j, m, fft_order, &ok) and
// col_mode<TJ, COLS>(k, ...), the modes of row j and column k (ok: the
// mode has outputs); row_phase(a, b, c, tab, row, &cs, &sn) and
// col_phase(a, b, c, tab, col, &cs, &sn), cos and sin of 2 pi times the
// phase in cycles of the point (its coordinates a, b, c; tab, its row of
// the table) at the row's or the column's mode; kTab, the table entries a
// point (0: no table), and then tab_fill<TJ, COLS>(tab, u1, u2, u3, j0, k0,
// m, fft_order, ptid), the stage's table for the tile (rows from j0,
// columns from k0) made by the producers, and tab_fits<TJ, COLS>(m),
// whether every tile's table fits (the launch refuses the width where not);
// rows<TJ>(m) and cols<TJ>(m), the rows a vector and the columns;
// outputs(m), the outputs a vector; out_index<TJ>(j, k, m, fft_order), the
// output of row j and column k, or -1 (cropped); Acc, the type in which
// the groups' partials are added.
#pragma once

#include "nufft_common.cuh"

namespace {

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
  float u1[TC_P], u2[TC_P], u3[TC_P];   // the points' stage coordinates
                                        // (P::point)
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

// Producer thread ptid always makes the same row mode (column a = ptid % TJ
// of v e1) and the same column mode (column b = ptid % COLS of e2), for the
// stage's points ptid / TJ + i NP / TJ and ptid / COLS + i NP / COLS.
template <class P, int G, int COLS>
struct TcModes {
  typename P::Row k1; // the row's mode (P::row_mode)
  typename P::Col k2; // the column's mode (P::col_mode)
  bool ok1, ok2;      // the mode has outputs
  __device__ TcModes(int ptid, int m, int fft_order, int j0, int k0) {
    constexpr int TJ = TC_ROWS / G;
    k1 = P::template row_mode<TJ>(j0 + ptid % TJ, m, fft_order, &ok1);
    k2 = P::template col_mode<TJ, COLS>(k0 + ptid % COLS, m, fft_order,
                                        &ok2);
  }
};

// One stage: the points p0.. up to p_end (their stage coordinates, once per
// point, and the values), then, where P has a table, its phases of the
// stage's points for the tile (P::tab_fill: one table, which only
// the producers read, so one buffer serves both stages: the barrier after
// the points keeps the next stage's fill from it until every producer is
// done with it), then v e1 for G vectors x TJ row modes and e2 for COLS
// column modes (zero where a mode has no output; a point past p_end has
// zero values, so its products vanish)
template <class P, int G, int COLS>
__device__ __forceinline__ void tc_fill(TcStage<COLS>& st, float2* tab,
                                        int ptid,
                                        const TcModes<P, G, COLS>& md,
                                        const typename P::X* __restrict__ x,
                                        const float2* __restrict__ v,
                                        float h, int n, int m, int fft_order,
                                        int b0, int gn, int j0, int k0,
                                        int p0, int p_end) {
  constexpr int TJ = TC_ROWS / G;
  constexpr int NP = TC_THREADS - TC_CONSUMERS;
  if (ptid < TC_P) {
    const int p = p0 + ptid;
    const bool ok = p < p_end;
    typename P::X xp = {};
    if (ok) xp = x[p];
    P::point(xp, h, &st.u1[ptid], &st.u2[ptid], &st.u3[ptid]);
#pragma unroll
    for (int g = 0; g < G; ++g)
      st.vq[g][ptid] = ok && g < gn ? v[(size_t)(b0 + g) * n + p]
                                    : make_float2(0.f, 0.f);
  }
  asm volatile("bar.sync %0, %1;" ::"n"(TC_BAR_POINTS), "n"(NP) : "memory");
  if constexpr (P::kTab > 0) {
    P::template tab_fill<TJ, COLS>(tab, st.u1, st.u2, st.u3, j0, k0, m,
                                   fft_order, ptid);
    asm volatile("bar.sync %0, %1;" ::"n"(TC_BAR_POINTS), "n"(NP)
                 : "memory");
  }
  const int a = ptid % TJ, b = ptid % COLS;
#pragma unroll
  for (int it = 0; it < TC_P * TJ / NP; ++it) {
    const int q = ptid / TJ + it * (NP / TJ);
    float c = 0.f, sn = 0.f;
    if (md.ok1)
      P::row_phase(st.u1[q], st.u2[q], st.u3[q], tab + q * P::kTab, md.k1,
                   &c, &sn);
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
    if (md.ok2)
      P::col_phase(st.u1[q], st.u2[q], st.u3[q], tab + q * P::kTab, md.k2,
                   &c, &sn);
    st.bre[q][b] = c;
    st.bim[q][b] = -sn;
  }
}

template <class P, int G, int COLS>
__global__ void __launch_bounds__(TC_THREADS, 1)
type1_tc_kernel(const typename P::X* __restrict__ x,
                const float2* __restrict__ v, float h, int n, int m, int nb,
                int fft_order, int acc_points, int run_points, int chunk,
                float2* __restrict__ partial) {
  using Tile = TcTile<COLS>;
  constexpr int TJ = TC_ROWS / G;
  constexpr int MI = Tile::MI, NI = Tile::NI, E = Tile::E;
  extern __shared__ float4 tc_smem[];
  TcStage<COLS>* stages = reinterpret_cast<TcStage<COLS>*>(tc_smem);
  const int ntk = (P::template cols<TJ>(m) + COLS - 1) / COLS;
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
    const TcModes<P, G, COLS> md(ptid, m, fft_order, j0, k0);
    // P's table, past the run sums
    float2* tab = reinterpret_cast<float2*>(
        reinterpret_cast<float*>(stages + 2) + E * TC_CONSUMERS);
    int s = 0;
    for (int r0 = p_begin; r0 < p_end; r0 += run_points) {
      const int r_end = min(p_end, r0 + run_points);
      for (int p0 = r0; p0 < r_end; p0 += TC_P, ++s) {
        if (s >= 2) bar_sync(TC_BAR_EMPTY + (s & 1));
        tc_fill<P, G, COLS>(stages[s & 1], tab, ptid, md, x, v, h, n, m,
                            fft_order, b0, gn, j0, k0, p0, r_end);
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
          const long long idx =
              P::template out_index<TJ>(j, k, m, fft_order);
          if (g < gn && idx >= 0) {
            const int e = (mi * NI + ni) * 8 + i;
            float2* o = partial +
                ((size_t)blockIdx.y * nb + b0 + g) * P::outputs(m) + idx;
            float2 t = first ? make_float2(0.f, 0.f) : *o;
            t.x = __fadd_rn(t.x, run[e][tid]);
            t.y = __fadd_rn(t.y, run[e + 4][tid]);
            *o = t;
          }
        }
  }
}

// `chunk` points a group, one partial per group, then the groups' partials
// added in group order
template <class P, int G, int COLS>
int launch_type1_tc_cols(const void* x, const void* v, float h, int n, int m,
                         int nb, int fft_order, int acc, int run, int chunk,
                         void* partial, void* out, cudaStream_t s) {
  constexpr int TJ = TC_ROWS / G;
  constexpr int smem = 2 * sizeof(TcStage<COLS>) +
                       TcTile<COLS>::E * TC_CONSUMERS * 4 +
                       TC_P * P::kTab * (int)sizeof(float2);
  if constexpr (P::kTab > 0) {
    if (!P::template tab_fits<TJ, COLS>(m)) return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaFuncSetAttribute(
      type1_tc_kernel<P, G, COLS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const int ntj = (P::template rows<TJ>(m) + TJ - 1) / TJ;
  const int ntk = (P::template cols<TJ>(m) + COLS - 1) / COLS;
  const int groups = (n + chunk - 1) / chunk;
  const dim3 grid(ntj * ntk, groups, (nb + G - 1) / G);
  type1_tc_kernel<P, G, COLS><<<grid, TC_THREADS, smem, s>>>(
      (const typename P::X*)x, (const float2*)v, h, n, m, nb, fft_order, acc,
      run, chunk, (float2*)partial);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_reduce<float, typename P::Acc>(
      partial, groups, (int)(nb * P::outputs(m)), out, s);
}

// The caller's geometry (rows x cols tile, batch group, points a register
// sum, a run and a group), checked against the instances there are
template <class P, int G>
int launch_type1_tc(const void* x, const void* v, float h, int n, int m,
                    int nb, int fft_order, int rows, int cols, int group,
                    int acc, int run, int chunk, void* partial, void* out,
                    void* stream) {
  if (rows != TC_ROWS || group != G || acc <= 0 || acc % TC_P != 0 ||
      run % acc != 0 || chunk <= 0 || chunk % run != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cols == 32)
    return launch_type1_tc_cols<P, G, 32>(x, v, h, n, m, nb, fft_order, acc,
                                          run, chunk, partial, out, s);
  if (cols == 128)
    return launch_type1_tc_cols<P, G, 128>(x, v, h, n, m, nb, fft_order, acc,
                                           run, chunk, partial, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
