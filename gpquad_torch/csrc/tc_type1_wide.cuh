// The float32 d=3 type-1 NUFFT on the tensor cores for the wide grids
// (nufft_3d.cu gpq_nufft1_3d_wide_f32): one kernel,
// type1_wide_kernel<TW_COLS>, which replaces, past mtot 64, gpquad's
// slab-tiled _pallas_nufft1_3d_tiled (gpquad/ops/pallas_nufft.py:1118) on
// the card:
//     out[b, j1, j2, j3] = sum_p v[b,p] e1(p,j1) e2(p,j2) e3(p,j3),
//                                              e = e^{-2 pi i c}.
//
// It is tc_type1.cuh's GEMM over the points, out = A^T E with 3xTF32 in
// 8-point mma chains, on another layout of the outputs: the rows are the
// pairs (j1, j2) of a vector laid end to end, i = j1 mtot + j2 (mtot^2 of
// them, in tiles of 64 with no padding past the last), the columns the
// modes j3 (tiles of COLS = TW_COLS = 128), and
//     A[p, i] = v_p e1(p, j1) e2(p, j2),   E[p, j3] = e3(p, j3).
// Every index here is centred (mode value j - half); the output's order
// (symmetric or FFT) is applied where a sum is stored.
//
// What held the float32 kernels back past mtot 64 (TPU row 12's regime):
// tc_type1.cuh on Type1Grid3D keeps a phase table of at most 72 entries a
// point, which past 64 forces 64 x 32 tiles whose rows are j3 alone, and
// each of their ~2 x 319 tiles at mtot 101 remade 64 row phases and 35
// table phases a point for 2 048 outputs: the producers set the pace, at
// 1.7x the CUDA cores' time; the CUDA-core kernel keeps 8 complex sums a
// thread and cannot pass the fp32 bound.  Here a tile's phases come from a
// table sized by the tile's own modes, each entry of A and E a product of
// two or three of its factors (the mode split j = 8 a + b, as the float64
// kernels split theirs):
//   - a row tile from i0 reaches at most three values of j1 (mtot >= 32),
//     idx = (i0 % mtot + r) / mtot for its row r, and one run of 64
//     consecutive j2 that wraps past mtot exactly where j1 steps: so
//     e2(j2) = e(u2, b2 - half + r) e(u2, -mtot idx), b2 = i0 % mtot, and
//     A[p, r] = ((v e1(j1) e(u2, -mtot idx)) C2[r / 8]) F2[r % 8] with
//     C2[a] = e(u2, b2 - half + 8 a), F2[b] = e(u2, b);
//   - a column tile from k0: E[p, c] = C3[c / 8] F3[c % 8] with
//     C3[a] = e(u3, k0 - half + 8 a), F3[b] = e(u3, b).
// That is 3 + 2 + 8 + 8 + COLS / 8 + 8 phases a point and tile (43 at
// COLS 128), not 64 + COLS, for 64 x COLS outputs; every phase is
// phase() of the torus coordinate (nufft_common.cuh), exact in its
// argument, and each product one complex multiply in fp32.  The producers
// then spend most of their time on products and the 3xTF32 splits, and
// the consumers' mma chains (12 a k-step and pair of 16 x 8 tiles) bound
// the kernel: 3 x 8 flops per point, output and vector on the tensor cores
// (495 TFLOP/s dense TF32), the output padding of j3 to whole tiles
// (101 -> 128) on top.  At 2e4 points and mtot 255 (NVIDIA H100 80GB
// HBM3, 700 W, scripts/time_type1_3d_wide.py) the consumers alone took
// 42.5 ms and the producers alone 26.8, together 52.0, against a 3xTF32
// bound of 16.2: mma.sync's TF32 rate, not the phases, sets the pace.
// wgmma m64n64k8 (A from registers, E split into K-major core matrices)
// took 36.0 ms alone, but with E's split made by the producers or by the
// consumers between products the whole took 57.7-82.5 ms: this design
// keeps mma.sync.
//
// Block, warp roles, stages, barriers and the sums' order are tc_type1.cuh's
// (512 threads: two producer warpgroups fill two stage buffers of TC_P
// points, two consumer warpgroups run the k-steps; a k-step's 8 points in
// one chain of six mma per accumulator started from zero, the k-steps of
// `acc` points added in fp32 registers, those sums of a run of `run`
// points in fp32 in shared memory, the runs into the group's partial in
// order, the groups in group order by launch_reduce; no atomics, the same
// bits on every launch).  The producers load a stage's points a stage
// ahead.  One vector a block (grid axis z): the batch shares nothing a
// block could keep.  Grid: (row tiles x column tiles, point groups,
// vectors); one group writes the output itself.
//
// The caller owns the geometry (ops/cuda_nufft.py type1_3d_wide_geometry):
// the column tile, `acc`, `run` and the points of a group (`chunk`); the
// launch refuses a geometry it has no instance for and mtot below
// TW_MIN_MTOT.
#pragma once

#include "tc_type1.cuh"

namespace {

// j1 values a row tile of TC_ROWS rows reaches: at most three from mtot 32
constexpr int TW_N1 = 3;
constexpr int TW_MIN_MTOT = 32;
// the column tile: modes j3 a tile, the one instance (32 took 1.31-1.60x
// its time where it pads j3 less, ops/cuda_nufft.py TYPE1_3D_WIDE_COLS)
constexpr int TW_COLS = 128;

// A point's table for a tile: its factors (made by phase()), then its
// padding to whole groups of eight entries
template <int COLS>
struct TwTab {
  static constexpr int kE1 = 0;                // v e1(j1) e(u2, -mtot idx)
  static constexpr int kC2 = kE1 + TW_N1;      // e(u2, b2 - half + 8 a)
  static constexpr int kF2 = kC2 + 8;          // e(u2, b)
  static constexpr int kC3 = kF2 + 8;          // e(u3, k0 - half + 8 a)
  static constexpr int kF3 = kC3 + COLS / 8;   // e(u3, b)
  static constexpr int kLen = (kF3 + 8 + 7) / 8 * 8;
};

// a b, both e^{-2 pi i c} as (cos, -sin), or any complex values
__device__ __forceinline__ float2 tw_mul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// e^{-2 pi i u k} as (cos, -sin)
__device__ __forceinline__ float2 tw_phase(float u, int k) {
  float c, s;
  phase(u, (float)k, &c, &s);
  return make_float2(c, -s);
}

// d = A (16x8, row) * B (8x8, col) on the tensor cores, the chain's first
// product (its sum starts from zero)
__device__ __forceinline__ void mma_tf32_first(float* d, const unsigned* a,
                                               const unsigned* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// Producer ptid < TC_P's point of the stage from p0 (zero past p_end): its
// coordinates and the vector's value, loaded a stage ahead
__device__ __forceinline__ void tw_load(const float3* __restrict__ x,
                                        const float2* __restrict__ v,
                                        int ptid, int p0, int p_end,
                                        float3* xp, float2* vp) {
  *xp = make_float3(0.f, 0.f, 0.f);
  *vp = make_float2(0.f, 0.f);
  if (ptid < TC_P && p0 + ptid < p_end) {
    *xp = x[p0 + ptid];
    *vp = v[p0 + ptid];
  }
}

// One stage: the points of the stage (their torus coordinates and the
// vector's values, from xp and vp, which then take the next stage's from
// p_next), then the tile's table of their factors, then A (v e1 e2, split
// into its four tf32 planes) for the 64 rows from i0 and E (e3) for the
// COLS columns from k0; zero where a row or a column has no output, and a
// point past the group's end has a zero value, so its products vanish.  A
// stage never straddles a run (runs are whole stages).
template <int COLS>
__device__ __forceinline__ void tw_fill(TcStage<COLS>& st, float2* tab,
                                        int ptid,
                                        const float3* __restrict__ x,
                                        const float2* __restrict__ v,
                                        float h, int m, int i0, int k0,
                                        int p_next, int p_end, float3* xp,
                                        float2* vp) {
  using T = TwTab<COLS>;
  constexpr int NP = TC_THREADS - TC_CONSUMERS;
  static_assert(NP == 8 * TC_P && NP % TC_ROWS == 0 && NP % COLS == 0,
                "eight producers a point; whole rows and columns a pass");
  if (ptid < TC_P) {
    st.u1[ptid] = torus(xp->x, h);
    st.u2[ptid] = torus(xp->y, h);
    st.u3[ptid] = torus(xp->z, h);
    st.vq[0][ptid] = *vp;
    tw_load(x, v, ptid, p_next, p_end, xp, vp);
  }
  asm volatile("bar.sync %0, %1;" ::"n"(TC_BAR_POINTS), "n"(NP) : "memory");
  const int half = (m - 1) / 2;
  const int j10 = i0 / m, b2 = i0 - j10 * m;
  // the table: entries ptid % 8 + 8 i of point ptid / 8
  {
    const int q = ptid / 8;
    float2* tq = tab + q * T::kLen;
#pragma unroll
    for (int i = 0; i < T::kLen / 8; ++i) {
      const int t = ptid % 8 + 8 * i;
      if (t < T::kE1 + TW_N1) {
        // (v e1(j1)) e(u2, -mtot idx), idx = t; the wrap's factor is 1 at
        // idx 0
        float2 e = tw_mul(st.vq[0][q], tw_phase(st.u1[q], j10 + t - half));
        if (t > 0) e = tw_mul(e, tw_phase(st.u2[q], -m * t));
        tq[t] = e;
      } else if (t < T::kF2) {
        tq[t] = tw_phase(st.u2[q], b2 - half + 8 * (t - T::kC2));
      } else if (t < T::kC3) {
        tq[t] = tw_phase(st.u2[q], t - T::kF2);
      } else if (t < T::kF3) {
        tq[t] = tw_phase(st.u3[q], k0 - half + 8 * (t - T::kC3));
      } else if (t < T::kF3 + 8) {
        tq[t] = tw_phase(st.u3[q], t - T::kF3);
      }
    }
  }
  asm volatile("bar.sync %0, %1;" ::"n"(TC_BAR_POINTS), "n"(NP) : "memory");
  // A: row r = ptid % 64 of points ptid / 64 + 4 it
  {
    const int r = ptid % TC_ROWS;
    const bool ok = i0 + r < m * m;
    const int idx = (b2 + r) / m;
#pragma unroll
    for (int it = 0; it < TC_P * TC_ROWS / NP; ++it) {
      const int q = ptid / TC_ROWS + it * (NP / TC_ROWS);
      const float2* tq = tab + q * T::kLen;
      float2 a = make_float2(0.f, 0.f);
      if (ok)
        a = tw_mul(tw_mul(tq[T::kE1 + idx], tq[T::kC2 + (r >> 3)]),
                   tq[T::kF2 + (r & 7)]);
      unsigned* o = &st.a_s[0][q][r];
      constexpr int PLANE = TC_P * TC_RS;
      split3(a.x, &o[0], &o[PLANE]);
      split3(a.y, &o[2 * PLANE], &o[3 * PLANE]);
    }
  }
  // E: column c = ptid % COLS of points ptid / COLS + (NP / COLS) it
  {
    const int c = ptid % COLS;
    const bool ok = k0 + c < m;
#pragma unroll
    for (int it = 0; it < TC_P * COLS / NP; ++it) {
      const int q = ptid / COLS + it * (NP / COLS);
      const float2* tq = tab + q * T::kLen;
      float2 e = make_float2(0.f, 0.f);
      if (ok) e = tw_mul(tq[T::kC3 + (c >> 3)], tq[T::kF3 + (c & 7)]);
      st.bre[q][c] = e.x;
      st.bim[q][c] = e.y;
    }
  }
}

// the output's place of centred index j (mode value j - half)
__device__ __forceinline__ int tw_out(int j, int m, int fft_order) {
  const int k = j - (m - 1) / 2;
  return fft_order ? (k >= 0 ? k : k + m) : j;
}

template <int COLS>
__global__ void __launch_bounds__(TC_THREADS, 1)
type1_wide_kernel(const float3* __restrict__ x,
                  const float2* __restrict__ v, float h, int n, int m,
                  int fft_order, int acc_points, int run_points, int chunk,
                  float2* __restrict__ partial) {
  using Tile = TcTile<COLS>;
  constexpr int MI = Tile::MI, NI = Tile::NI, E = Tile::E;
  extern __shared__ float4 tw_smem[];
  TcStage<COLS>* stages = reinterpret_cast<TcStage<COLS>*>(tw_smem);
  const int ntk = (m + COLS - 1) / COLS;
  const int i0 = (blockIdx.x / ntk) * TC_ROWS;
  const int k0 = (blockIdx.x % ntk) * COLS;
  const int b = blockIdx.z;
  const int p_begin = blockIdx.y * chunk;
  const int p_end = min(n, p_begin + chunk);
  const int tid = threadIdx.x;
  const long long mmm = (long long)m * m * m;

  if (tid >= TC_CONSUMERS) {
    // producers: fill stage s into buffer s & 1 once the consumers are done
    // with stage s - 2; at the end take the consumers' last two releases
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::);
    const int ptid = tid - TC_CONSUMERS;
    float2* tab = reinterpret_cast<float2*>(
        reinterpret_cast<float*>(stages + 2) + E * TC_CONSUMERS);
    const float2* vb = v + (size_t)b * n;
    float3 xp;
    float2 vp;
    tw_load(x, vb, ptid, p_begin, p_end, &xp, &vp);
    int s = 0;
    for (int r0 = p_begin; r0 < p_end; r0 += run_points) {
      const int r_end = min(p_end, r0 + run_points);
      for (int p0 = r0; p0 < r_end; p0 += TC_P, ++s) {
        if (s >= 2) bar_sync(TC_BAR_EMPTY + (s & 1));
        tw_fill<COLS>(stages[s & 1], tab, ptid, x, vb, h, m, i0, k0,
                      p0 + TC_P, p_end, &xp, &vp);
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
          for (int bb = 0; bb < NI; ++bb)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[a][bb][c] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < TC_P; ks += 8) {
        // A fragments of the warp's m-tiles: a0 (g, t), a1 (g+8, t),
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
          // small*big, big*small, big*big; Re += Ar Er + Ai (-Ei),
          // Im += Ar Ei + Ai Er.  Each pass runs over all 8 chains, so
          // consecutive mma do not wait on each other; the first pass
          // starts them.
#pragma unroll
          for (int pass = 0; pass < 3; ++pass) {
            const int sa = pass == 0 ? 1 : 0;     // A's split
            const int sb = pass == 1 ? 1 : 0;     // B's split
#pragma unroll
            for (int nn = 0; nn < 2; ++nn)
#pragma unroll
              for (int mi = 0; mi < MI; ++mi) {
                if (pass == 0) {
                  mma_tf32_first(&d[mi][nn][0], ar[sa][mi], br[sb][nn]);
                  mma_tf32_first(&d[mi][nn][4], ar[sa][mi], bi[sb][nn]);
                } else {
                  mma_tf32(&d[mi][nn][0], ar[sa][mi], br[sb][nn]);
                  mma_tf32(&d[mi][nn][4], ar[sa][mi], bi[sb][nn]);
                }
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
        for (int bb = 0; bb < NI; ++bb)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int e = (a * NI + bb) * 8 + c;
            run[e][tid] = __fadd_rn(run[e][tid], acc[a][bb][c]);
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
          const int row = i0 + wr + mi * 16 + gq + (i >> 1) * 8;
          const int j3 = k0 + wc + ni * 8 + 2 * tq + (i & 1);
          if (row < m * m && j3 < m) {
            const int j1 = row / m, j2 = row - j1 * m;
            const long long idx =
                ((long long)tw_out(j1, m, fft_order) * m +
                 tw_out(j2, m, fft_order)) * m + tw_out(j3, m, fft_order);
            const int e = (mi * NI + ni) * 8 + i;
            float2* o = partial + ((long long)blockIdx.y * gridDim.z + b) *
                                      mmm + idx;
            float2 t = first ? make_float2(0.f, 0.f) : *o;
            t.x = __fadd_rn(t.x, run[e][tid]);
            t.y = __fadd_rn(t.y, run[e + 4][tid]);
            *o = t;
          }
        }
  }
}

// `chunk` points a group, one partial per group, then the groups' partials
// added in group order; one group writes the output itself
template <int COLS>
int launch_type1_wide_cols(const void* x, const void* v, float h, int n,
                           int m, int nb, int fft_order, int acc, int run,
                           int chunk, void* partial, void* out,
                           cudaStream_t s) {
  constexpr int smem = 2 * sizeof(TcStage<COLS>) +
                       TcTile<COLS>::E * TC_CONSUMERS * 4 +
                       TC_P * TwTab<COLS>::kLen * (int)sizeof(float2);
  int err = (int)cudaFuncSetAttribute(
      type1_wide_kernel<COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != 0) return err;
  const int ntj = (m * m + TC_ROWS - 1) / TC_ROWS;
  const int ntk = (m + COLS - 1) / COLS;
  const int groups = (n + chunk - 1) / chunk;
  const dim3 grid(ntj * ntk, groups, nb);
  type1_wide_kernel<COLS><<<grid, TC_THREADS, smem, s>>>(
      (const float3*)x, (const float2*)v, h, n, m, fft_order, acc, run, chunk,
      (float2*)(groups == 1 ? out : partial));
  err = (int)cudaGetLastError();
  if (err != 0 || groups == 1) return err;
  return launch_reduce<float, float>(partial, groups,
                                     (int)(nb * (long long)m * m * m), out,
                                     s);
}

// The caller's geometry (rows x cols tile, points a register sum, a run and
// a group), checked against the instances there are
int launch_type1_wide(const void* x, const void* v, float h, int n, int m,
                      int nb, int fft_order, int rows, int cols, int acc,
                      int run, int chunk, void* partial, void* out,
                      void* stream) {
  if (rows != TC_ROWS || m < TW_MIN_MTOT || acc <= 0 || acc % TC_P != 0 ||
      run % acc != 0 || chunk <= 0 || chunk % run != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cols == TW_COLS)
    return launch_type1_wide_cols<TW_COLS>(x, v, h, n, m, nb, fft_order, acc,
                                           run, chunk, partial, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
