// The float64 type-1 NUFFT on the H100's FP64 tensor cores (DMMA,
// mma.sync.aligned.m16n8k8 .f64), single and batched: one kernel,
// type1_f64_kernel<P, G, COLS>, whose problem type P says what its rows,
// columns and points are:
//  - d=2 (nufft_2d.cu Type1F64Grid2D): row j is mode j - half of the first
//    axis, column k mode k - half of the second; output (j, k) of the
//    mtot x mtot grid.  It replaces, in float64, the TPU's pallas_nufft1_2d
//    / _pallas_nufft1_2d_tiled (gpquad/ops/pallas_nufft.py:195, :442) and
//    pallas_nufft1_2d_batched (:914);
//  - d=3 (nufft_3d.cu Type1F64Grid3D): the first axis's mode split as
//    k1 = S q + r, row (r, j3) and column (q, j2), as the float32 kernel's
//    Type1Grid3D has them; output (j1, j2, j3) of the mtot^3 grid.  It
//    replaces, in float64, pallas_nufft1_3d / _pallas_nufft1_3d_tiled
//    (:750, :1118);
//  - d=1 (nufft_1d.cu Type1F64Split1D): the mode split as k = S q + r,
//    row r and column q, as the float32 kernel's Type1Split1D has them;
//    output k of the mtot modes.  It replaces, in float64,
//    pallas_nufft1_1d (:584).
// gpquad runs their float64 form as its double-word type-1
// (gpquad/ops/nufft_df.py:95 df_nufft1); here float64 is native.
//
// The sum over points is a GEMM whose reduction axis is the points:
//   out = A^T E,  A[p, (b, i)] = v_b[p] a(p, i),  E[p, c] = e(p, c),
// complex (e = e^{-2 pi i c}), as four real float64 products on the tensor
// cores:  out_re = Ar^T Er + Ai^T (-Ei),  out_im = Ar^T Ei + Ai^T Er.  No
// split of the operands: DMMA takes float64 as it is.
//
// What bounds it on an H100: 8 flops a point, output and vector on the
// tensor cores (67 TFLOP/s dense float64), and the phases on the CUDA cores
// (34 TFLOP/s).  A float64 sincospi costs tens of flops, and a tile of TJ x
// COLS outputs would need TJ + COLS phases a point, nearly as many flops as
// the products.  So each operand index is split.  Index i of an operand (a
// row of A a vector, or a column of E) is the inner mode i - o mi + base of
// one coordinate u (o = i / mi, its outer index; P::inner gives mi, and
// P::row_base / col_base the operand's base: -half at d=2 and d=3, 0 for
// d=1's rows, qmin for its columns), times an outer factor of o where P
// has one (d=3: e(u1, r) for a row, e(u1, S q) for a column; at d=1 and
// d=2 mi passes every index and o is 0).  With i = i0 + K a + t, i0 the
// tile's first index and t < K:
//   e(u, i - o mi + base) = e(u, i0 + K a - o mi + base) e(u, t),
// each factor from nufft_common.cuh's phase<double> (the torus fold, the
// compensated u k, sincospi; where P::kCarry, d=1, phase_split<double>,
// the rounding error of t = x h carried into every phase, as the float32
// d=1 kernels carry it).  A group of K indices spans one or two outer
// values (mi >= K), so an entry is one complex product of the group's
// coarse factor for its o (the outer factor and, in A, v folded in) and a
// fine factor e(u, t).  A point then makes K + TJ / K row phases and K +
// COLS / K column phases a tile (32 at 64 x 64 at d=2, not 128; at d=3
// also a second coarse factor for each group across a boundary of o, and
// the outer factors: ~40; at d=1 28 at 64 x 32, against mtot a point on
// the CUDA cores).  At d=1 the column's coordinate is S u (S a power of
// two, so that S x is exact and so is its rounding error), whose mode
// q + qmin is e(u, S (q + qmin)).  The twins (ops/cuda_nufft.py
// nufft1_2d_f64_tc_ref, nufft1_3d_f64_tc_ref, nufft1_1d_f64_tc_ref) form
// every entry the same way.
//
// Block: 512 threads in four warpgroups over a 64 x COLS output tile (rows:
// G vectors x TJ = 64 / G indices i; COLS 32 or 64 indices c), grid (row
// tiles x column tiles, point groups, batch groups):
//  - two producer warpgroups (setmaxnreg 72) make, once a block, the tile's
//    list of factors (P's coordinate and mode of each) and its groups'
//    places in it (t64_list); then, per stage of T64_P points, the points'
//    torus coordinates and values (loaded from device memory a stage
//    ahead), then the list's factors a point, then the stage's operands A =
//    v a and E into a shared-memory stage buffer, each entry one complex
//    product of two factors, a producer writing the K entries of one group
//    in 16-byte stores;
//  - two consumer warpgroups (setmaxnreg 184), 8 warps of WM x WN warp
//    tiles (32 x 16 at COLS 64, 16 x 16 at 32), run the stage's k-steps of
//    8 points, four m16n8k8 DMMA a 16 x 8 output tile and k-step.
// Two stage buffers; named barriers hand each one over (as tc_type1.cuh).
// Taken apart on the card (scripts/time_type1_2d_f64.py: no phases, no
// fill, no mma), the d=2 consumers alone run at ~83% of the FP64
// tensor-core rate at n 1e6 x mtot 339 and the producers alone take ~0.8x
// their time; together the kernel reaches ~40% of its bound there: the two
// roles' work adds more than it overlaps.
//
// The sum, in a fixed order and with no atomics:
//  - a run of `run` points in the DMMA accumulators: k-step after k-step
//    from zero, each k-step adding Ar Er then Ai (-Ei) into the real part
//    and Ar Ei then Ai Er into the imaginary part (the tensor cores add a
//    k-step's 8 products and the accumulator in their own order);
//  - the runs of the block's point group added into the group's partial
//    in device memory, in run order (each thread reading back only what it
//    wrote);
//  - launch_reduce adds the groups' partials in group order (one group
//    writes the output itself where the caller passes it as the partial).
// The same bits on every launch.  ops/cuda_nufft.py type1_2d_geometry,
// type1_3d_geometry and type1_1d_geometry own the geometry (tile, group,
// P's split S, run, the points a group) and the launch refuses one it has
// no instance for; the scratch holds groups x B x outputs values.
//
// The problem type P provides: X, the point's type in x, and coord(x, c),
// its coordinate c < kCoords (coord(x, c, S) where kCarry: then each
// coordinate's phases carry the rounding error of its t = coord h);
// kRowCoord and kColCoord, the coordinates of A's and E's inner modes;
// row_base(m, S) and col_base(m, S), the mode of index 0 of each (its
// outer value's); kOuter, whether an index has an outer factor,
// and then row_outer(o, m, S) and col_outer(o, m, S), the mode of the outer
// factor e(u1, .) of outer value o; inner(m), mi; split_ok(m, S), whether
// S is a split it has; rows(m, S) and cols(m, S), the indices a vector;
// outputs(m); out_index(i, c, m, S, fft_order), the output of row i and
// column c, or -1 (none: padding, or cropped); max_factors<S1, S2>(), the
// most factors a point, and fixed_factors<S1, S2>(), their number where it
// does not depend on the tile (else 0).
#pragma once

#include "tc_type1.cuh"

namespace {

constexpr int T64_THREADS = 512;
constexpr int T64_CONSUMERS = 256;   // warpgroups 0-1; 2-3 produce
constexpr int T64_ROWS = 64;
constexpr int T64_P = 32;            // points a stage
constexpr int T64_K = 8;             // the split's t = 0 .. K - 1
constexpr int T64_RS = T64_ROWS + 4;  // padded strides (doubles): a
                                      // fragment load's half-warp reads 16
                                      // distinct 8-byte bank pairs

// The consumers' warp grid over a T64_ROWS x COLS tile: WR x WC warps of
// MI 16-row m-tiles by NI 8-column n-tiles.
template <int COLS>
struct T64Tile {
  static_assert(COLS == 32 || COLS == 64, "tile widths: 32, 64");
  static constexpr int WC = COLS == 64 ? 4 : 2;
  static constexpr int WR = T64_CONSUMERS / 32 / WC;
  static constexpr int WM = T64_ROWS / WR, WN = COLS / WC;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int CS = COLS + 4;
};

// A stage's operands, point-major: A's real and imaginary parts (rows (g,
// i)) and E's (columns c)
template <int COLS>
struct T64Stage {
  double ar[T64_P][T64_RS], ai[T64_P][T64_RS];
  double br[T64_P][T64Tile<COLS>::CS], bi[T64_P][T64Tile<COLS>::CS];
};

// A group of T64_K operand indices i0 + K a + t: the places in the factor
// list of its coarse factors for its first outer value o and its last (the
// same where it has one), of their outer factors (where P has them), and
// the first t of the last (T64_K where it has one)
struct T64Group {
  short c0, c1, o0, o1;
  int tb;
};

// What the producers make of a tile and of a stage's points before its
// operands (one copy: only the producers read it, and their barriers order
// its uses)
template <class P, int G, int COLS>
struct T64Tables {
  static constexpr int S1 = T64_ROWS / G / T64_K, S2 = COLS / T64_K;
  static constexpr int NE = P::template max_factors<S1, S2>();
  double u[P::kCoords][T64_P];     // torus coordinates
  // where P::kCarry, the rounding errors of their t = coord h
  double te[P::kCarry ? P::kCoords : 1][T64_P];
  double2 v[G][T64_P];             // the group's values
  double2 f[T64_P][NE];            // the factors of a point, in list order
  int2 list[NE];                   // factor t: its coordinate and mode
  T64Group ga[S1], gb[S2];         // A's groups of rows, E's of columns
  int ne;                          // the list's length
};

// d += A (16x8, row) * B (8x8, col) on the FP64 tensor cores
__device__ __forceinline__ void mma_f64(double* d, const double* a,
                                        const double* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// (a.x + i a.y)(b.x + i b.y)
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}

// A stage's point (producer thread ptid < T64_P): its coordinates and
// values, loaded one stage ahead of their use
template <class P, int G>
struct T64Point {
  typename P::X x;
  double2 v[G];
  // point p0 + ptid of a stage that ends at p_end (zero values past it, so
  // that its products vanish)
  __device__ __forceinline__ void load(const typename P::X* __restrict__ xs,
                                       const double2* __restrict__ vs, int n,
                                       int b0, int gn, int ptid, int p0,
                                       int p_end) {
    const int p = p0 + ptid;
    const bool ok = ptid < T64_P && p < p_end;
    x = ok ? xs[p] : typename P::X{};
#pragma unroll
    for (int g = 0; g < G; ++g)
      v[g] = ok && g < gn ? vs[(size_t)(b0 + g) * n + p]
                          : make_double2(0.0, 0.0);
  }
};

// An operand's groups of indices first .. first + K ng - 1 of inner
// coordinate `coord`: each group's coarse factors appended to the list
// (mode i - o mi + base for its first index i and each outer value o it
// spans), their places and the group's boundary in gr; the outer places
// relative to first / mi
__device__ __forceinline__ void t64_groups(int2* list, int* ne, T64Group* gr,
                                           int ng, int first, int coord,
                                           int mi, int base) {
  for (int a = 0; a < ng; ++a) {
    const int i = first + T64_K * a;
    const int o = i / mi, o1 = (i + T64_K - 1) / mi;
    gr[a].c0 = (short)*ne;
    list[(*ne)++] = make_int2(coord, i - o * mi + base);
    if (o1 > o) {
      gr[a].c1 = (short)*ne;
      list[(*ne)++] = make_int2(coord, i - o1 * mi + base);
    } else {
      gr[a].c1 = gr[a].c0;
    }
    gr[a].tb = o1 > o ? o1 * mi - i : T64_K;
    gr[a].o0 = (short)(o - first / mi);
    gr[a].o1 = (short)(o1 - first / mi);
  }
}

// The tile's factor list (one producer thread, once a block): A's fine
// factors e(u, t), E's, A's groups' coarse factors, E's, then (where P has
// them) the outer factors of the outer values A's rows i0 .. i0 + TJ - 1
// reach, and E's columns c0 .. c0 + COLS - 1
template <class P, int G, int COLS>
__device__ void t64_list(T64Tables<P, G, COLS>& tb, int i0, int c0, int m,
                         int split) {
  using Tb = T64Tables<P, G, COLS>;
  constexpr int TJ = T64_ROWS / G;
  const int mi = P::inner(m);
  int ne = 0;
  for (int t = 0; t < T64_K; ++t) tb.list[ne++] = make_int2(P::kRowCoord, t);
  for (int t = 0; t < T64_K; ++t) tb.list[ne++] = make_int2(P::kColCoord, t);
  t64_groups(tb.list, &ne, tb.ga, Tb::S1, i0, P::kRowCoord, mi,
             P::row_base(m, split));
  t64_groups(tb.list, &ne, tb.gb, Tb::S2, c0, P::kColCoord, mi,
             P::col_base(m, split));
  if constexpr (P::kOuter) {
    const int oa = ne;
    for (int o = i0 / mi; o <= (i0 + TJ - 1) / mi; ++o)
      tb.list[ne++] = make_int2(0, P::row_outer(o, m, split));
    const int ob = ne;
    for (int o = c0 / mi; o <= (c0 + COLS - 1) / mi; ++o)
      tb.list[ne++] = make_int2(0, P::col_outer(o, m, split));
    for (int a = 0; a < Tb::S1; ++a) {
      tb.ga[a].o0 += oa;
      tb.ga[a].o1 += oa;
    }
    for (int b = 0; b < Tb::S2; ++b) {
      tb.gb[b].o0 += ob;
      tb.gb[b].o1 += ob;
    }
  }
  tb.ne = ne;
}

// One stage: its points (`pt`, loaded a stage ahead; then the next stage's,
// from np0 up to np_end, are loaded into `pt`), then the list's factors,
// then the operands
template <class P, int G, int COLS>
__device__ __forceinline__ void t64_fill(T64Stage<COLS>& st,
                                         T64Tables<P, G, COLS>& tb, int ptid,
                                         T64Point<P, G>& pt,
                                         const typename P::X* __restrict__ x,
                                         const double2* __restrict__ v,
                                         double h, int n, int b0, int gn,
                                         int split, int np0, int np_end) {
  using Tb = T64Tables<P, G, COLS>;
  constexpr int NP = T64_THREADS - T64_CONSUMERS;
  constexpr int TJ = T64_ROWS / G, K = T64_K;
  constexpr int FIXED = P::template fixed_factors<Tb::S1, Tb::S2>();
  const int ne = FIXED > 0 ? FIXED : tb.ne;
  if (ptid < T64_P) {
#pragma unroll
    for (int c = 0; c < P::kCoords; ++c) {
      if constexpr (P::kCarry)
        tb.u[c][ptid] = torus_split(P::coord(pt.x, c, split), h,
                                    &tb.te[c][ptid]);
      else
        tb.u[c][ptid] = torus(P::coord(pt.x, c), h);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) tb.v[g][ptid] = pt.v[g];
    pt.load(x, v, n, b0, gn, ptid, np0, np_end);
  }
  asm volatile("bar.sync %0, %1;" ::"n"(TC_BAR_POINTS), "n"(NP) : "memory");
  for (int e = ptid; e < T64_P * ne; e += NP) {
    const int q = e / ne, t = e % ne;
    const int2 d = tb.list[t];
    double c, sn;
    if constexpr (P::kCarry)
      phase_split(tb.u[d.x][q], tb.te[d.x][q], (double)d.y, &c, &sn);
    else
      phase(tb.u[d.x][q], (double)d.y, &c, &sn);
    tb.f[q][t] = make_double2(c, -sn);
  }
  asm volatile("bar.sync %0, %1;" ::"n"(TC_BAR_POINTS), "n"(NP) : "memory");
  // the operands: a thread takes one group of K indices of its point (v
  // folded in for A) and writes its K entries, each the coarse factor of
  // its outer value times e(u, t), pairs in a rotated order (first pair
  // (s' >> 1) & 3, s' the group's place among the point's 8), so that the
  // 16-byte stores of 8 neighbouring threads fall on distinct banks
  static_assert(T64_P * Tb::S1 * G == NP, "one A group a producer");
  static_assert(T64_P * Tb::S2 <= NP, "at most one E group a producer");
  {
    const int q = ptid / (G * Tb::S1), gs = ptid % (G * Tb::S1);
    const T64Group gr = tb.ga[gs % Tb::S1];
    double2 w0 = tb.f[q][gr.c0], w1 = tb.f[q][gr.c1];
    if constexpr (P::kOuter) {
      w0 = cmul(tb.f[q][gr.o0], w0);
      w1 = cmul(tb.f[q][gr.o1], w1);
    }
    const double2 vq = tb.v[gs / Tb::S1][q];
    const double2 f0 = cmul(vq, w0), f1 = cmul(vq, w1);
    const int base = (gs / Tb::S1) * TJ + (gs % Tb::S1) * K;
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const int r = 2 * ((i + (gs >> 1)) & (K / 2 - 1));
      const double2 a0 = cmul(r < gr.tb ? f0 : f1, tb.f[q][r]);
      const double2 a1 = cmul(r + 1 < gr.tb ? f0 : f1, tb.f[q][r + 1]);
      *reinterpret_cast<double2*>(&st.ar[q][base + r]) =
          make_double2(a0.x, a1.x);
      *reinterpret_cast<double2*>(&st.ai[q][base + r]) =
          make_double2(a0.y, a1.y);
    }
  }
  if (ptid < T64_P * Tb::S2) {
    const int q = ptid / Tb::S2, sc = ptid % Tb::S2;
    const T64Group gr = tb.gb[sc];
    double2 f0 = tb.f[q][gr.c0], f1 = tb.f[q][gr.c1];
    if constexpr (P::kOuter) {
      f0 = cmul(tb.f[q][gr.o0], f0);
      f1 = cmul(tb.f[q][gr.o1], f1);
    }
    const int base = sc * K;
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const int r = 2 * ((i + (sc >> 1)) & (K / 2 - 1));
      const double2 b0 = cmul(r < gr.tb ? f0 : f1, tb.f[q][K + r]);
      const double2 b1 = cmul(r + 1 < gr.tb ? f0 : f1, tb.f[q][K + r + 1]);
      *reinterpret_cast<double2*>(&st.br[q][base + r]) =
          make_double2(b0.x, b1.x);
      *reinterpret_cast<double2*>(&st.bi[q][base + r]) =
          make_double2(b0.y, b1.y);
    }
  }
}

// a symmetric-order mode index j (mode j - half) -> its output index
__device__ __forceinline__ int t64_out(int j, int m, int fft_order) {
  const int half = (m - 1) / 2;
  return fft_order ? (j >= half ? j - half : j + m - half) : j;
}

template <class P, int G, int COLS>
__global__ void __launch_bounds__(T64_THREADS, 1)
type1_f64_kernel(const typename P::X* __restrict__ x,
                 const double2* __restrict__ v, double h, int n, int m,
                 int nb, int fft_order, int split, int run_points, int chunk,
                 double2* __restrict__ partial) {
  using Tile = T64Tile<COLS>;
  constexpr int TJ = T64_ROWS / G;
  constexpr int MI = Tile::MI, NI = Tile::NI;
  extern __shared__ double2 t64_smem[];
  T64Stage<COLS>* stages = reinterpret_cast<T64Stage<COLS>*>(t64_smem);
  const int ntk = (P::cols(m, split) + COLS - 1) / COLS;
  const int j0 = (blockIdx.x / ntk) * TJ;
  const int k0 = (blockIdx.x % ntk) * COLS;
  const int b0 = blockIdx.z * G;
  const int gn = min(G, nb - b0);
  const int p_begin = blockIdx.y * chunk;
  const int p_end = min(n, p_begin + chunk);
  const int tid = threadIdx.x;

  if (tid >= T64_CONSUMERS) {
    // producers: the tile's factor list, then fill stage s into buffer s &
    // 1 once the consumers are done with stage s - 2; at the end take the
    // consumers' last two releases
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::);
    constexpr int NP = T64_THREADS - T64_CONSUMERS;
    const int ptid = tid - T64_CONSUMERS;
    T64Tables<P, G, COLS>& tb =
        *reinterpret_cast<T64Tables<P, G, COLS>*>(stages + 2);
    if (ptid == 0) t64_list(tb, j0, k0, m, split);
    T64Point<P, G> pt;
    pt.load(x, v, n, b0, gn, ptid, p_begin,
            min(p_end, p_begin + run_points));
    asm volatile("bar.sync %0, %1;" ::"n"(TC_BAR_POINTS), "n"(NP) : "memory");
    int s = 0;
    for (int r0 = p_begin; r0 < p_end; r0 += run_points) {
      const int r_end = min(p_end, r0 + run_points);
      for (int p0 = r0; p0 < r_end; p0 += T64_P, ++s) {
        // the stage after this one: in this run, or the next run's first
        const bool last = p0 + T64_P >= r_end;
        const int np0 = last ? r_end : p0 + T64_P;
        const int np_end = last ? min(p_end, r_end + run_points) : r_end;
        if (s >= 2) bar_sync(TC_BAR_EMPTY + (s & 1));
        t64_fill<P, G, COLS>(stages[s & 1], tb, ptid, pt, x, v, h, n, b0, gn,
                             split, np0, np_end);
        bar_arrive(TC_BAR_FULL + (s & 1));
      }
    }
    for (int t = max(s - 2, 0); t < s; ++t) bar_sync(TC_BAR_EMPTY + (t & 1));
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n" ::);
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;     // fragment row / column
  const int wr = (warp / Tile::WC) * Tile::WM;
  const int wc = (warp % Tile::WC) * Tile::WN;
  const size_t outputs = (size_t)P::outputs(m);

  int s = 0;
  double acc[MI][NI][8];   // a run's sums: [m][n][re 4, im 4]
  for (int r0 = p_begin; r0 < p_end; r0 += run_points) {
    const int r_end = min(p_end, r0 + run_points);
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int b = 0; b < NI; ++b)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][b][c] = 0.0;
    for (int p0 = r0; p0 < r_end; p0 += T64_P, ++s) {
      bar_sync(TC_BAR_FULL + (s & 1));
      const T64Stage<COLS>& st = stages[s & 1];
#pragma unroll
      for (int ks = 0; ks < T64_P; ks += 8) {
        // A fragments: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
        // rows are output rows, columns points
        double ar[MI][4], ai[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int r = wr + mi * 16 + gq;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = ks + tq + (i >> 1) * 4;
            const int rr = r + (i & 1) * 8;
            ar[mi][i] = st.ar[q][rr];
            ai[mi][i] = st.ai[q][rr];
          }
        }
        // B fragments: b0 (t, g), b1 (t+4, g); rows points, columns modes
        double br[NI][2], bi[NI][2], nbi[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int cidx = wc + ni * 8 + gq;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = ks + tq + i * 4;
            br[ni][i] = st.br[q][cidx];
            bi[ni][i] = st.bi[q][cidx];
            nbi[ni][i] = -bi[ni][i];
          }
        }
        // Re += Ar Er, Im += Ar Ei; then Re += Ai (-Ei), Im += Ai Er.  Each
        // pass runs over all the warp's accumulators, so that consecutive
        // mma do not wait on each other.
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_f64(&acc[mi][ni][0], ar[mi], br[ni]);
            mma_f64(&acc[mi][ni][4], ar[mi], bi[ni]);
          }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_f64(&acc[mi][ni][0], ai[mi], nbi[ni]);
            mma_f64(&acc[mi][ni][4], ai[mi], br[ni]);
          }
      }
      bar_arrive(TC_BAR_EMPTY + (s & 1));
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
          const int g = row / TJ;
          const int k = k0 + wc + ni * 8 + 2 * tq + (i & 1);
          const long long idx =
              P::out_index(j0 + row % TJ, k, m, split, fft_order);
          if (g < gn && idx >= 0) {
            double2* o = partial +
                ((size_t)blockIdx.y * nb + b0 + g) * outputs + idx;
            double2 t = first ? make_double2(0.0, 0.0) : *o;
            t.x = __dadd_rn(t.x, acc[mi][ni][i]);
            t.y = __dadd_rn(t.y, acc[mi][ni][4 + i]);
            *o = t;
          }
        }
  }
}

// `chunk` points a group, one partial per group, then the groups' partials
// added in group order (none where one group writes the output itself)
template <class P, int G, int COLS>
int launch_type1_f64_cols(const void* x, const void* v, double h, int n,
                          int m, int nb, int fft_order, int split, int run,
                          int chunk, void* partial, void* out,
                          cudaStream_t s) {
  constexpr int TJ = T64_ROWS / G;
  constexpr int smem =
      2 * sizeof(T64Stage<COLS>) + sizeof(T64Tables<P, G, COLS>);
  int err = (int)cudaFuncSetAttribute(
      type1_f64_kernel<P, G, COLS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const int ntj = (P::rows(m, split) + TJ - 1) / TJ;
  const int ntk = (P::cols(m, split) + COLS - 1) / COLS;
  const int groups = (n + chunk - 1) / chunk;
  const dim3 grid(ntj * ntk, groups, (nb + G - 1) / G);
  type1_f64_kernel<P, G, COLS><<<grid, T64_THREADS, smem, s>>>(
      (const typename P::X*)x, (const double2*)v, h, n, m, nb, fft_order,
      split, run, chunk, (double2*)partial);
  err = (int)cudaGetLastError();
  if (err != 0 || partial == out) return err;
  return launch_reduce<double>(partial, groups, (int)(nb * P::outputs(m)),
                               out, s);
}

// The caller's geometry (rows x cols tile, batch group, P's split, points
// a run and a group), checked against the instances there are; the partial
// may be the output only where the points make one group
template <class P, int G>
int launch_type1_f64(const void* x, const void* v, double h, int n, int m,
                     int nb, int fft_order, int rows, int cols, int group,
                     int split, int run, int chunk, void* partial, void* out,
                     void* stream) {
  if (rows != T64_ROWS || group != G || run <= 0 || run % T64_P != 0 ||
      chunk <= 0 || chunk % run != 0 || !P::split_ok(m, split) ||
      (partial == out && n > chunk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cols == 32)
    return launch_type1_f64_cols<P, G, 32>(x, v, h, n, m, nb, fft_order,
                                           split, run, chunk, partial, out, s);
  if (cols == 64)
    return launch_type1_f64_cols<P, G, 64>(x, v, h, n, m, nb, fft_order,
                                           split, run, chunk, partial, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
