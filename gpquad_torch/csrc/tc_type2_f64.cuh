// The float64 type-2 NUFFT on the H100's FP64 tensor cores (DMMA,
// mma.sync.aligned.m16n8k8 .f64): one kernel, type2_f64_kernel<P, NC>,
// whose problem type P says what its reduction index, its columns and its
// points are:
//  - d=2 (nufft_2d.cu Type2F64Grid2D), batched and at B 1 for the single:
//    k the modes of the second axis, j those of the first.  It replaces, in
//    float64, the TPU's pallas_nufft2_2d_batched
//    (gpquad/ops/pallas_nufft.py:838; its kernel _type2_kernel_b, :809-833,
//    is this product) and, where ops/cuda_nufft.py
//    type2_2d_single_geometry sends it, pallas_nufft2_2d and
//    _pallas_nufft2_2d_tiled (:113, :369) at B 1;
//  - d=3 (nufft_3d.cu Type2F64Grid3D), one vector or a batch: k the pairs
//    (j2, j3), j the modes of the first axis.  It replaces, in float64,
//    pallas_nufft2_3d and _pallas_nufft2_3d_tiled (:662, :1034);
//  - d=1 (nufft_1d.cu Type2F64Split1D), one vector or a batch: the mode
//    split as k = K q + r (K a power of two, the launch's `split`), k the
//    values q, j the values r.  It replaces, in float64, pallas_nufft2_1d
//    (:549).
// gpquad runs their float64 form as its double-word type-2
// (gpquad/ops/nufft_df.py:304 df_nufft2_real); here float64 is native.
//
// For the block's P points (e = e^{+2 pi i c}, complex):
//   T[p, (b, j)] = sum_k eA(p, k) F_b[j, k]      a GEMM over k,
//   out[b, p]    = sum_j e1(p, j) T[p, (b, j)]   in its epilogue,
// the GEMM as four real float64 products on the tensor cores:
//   T_re = C Fr + S (-Fi),   T_im = C Fi + S Fr   (C, S: cos, sin of eA),
// with no split of the operands: DMMA takes float64 as it is.
//
// What bounds it on an H100: 8 flops a point, mode (pair at d=2, triple at
// d=3) and vector on the tensor cores (67 TFLOP/s dense float64), the
// phases, the products of A's factors and the epilogue on the CUDA cores
// (34 TFLOP/s).  A float64 sincospi costs tens of flops, so the modes are
// taken in symmetric order (index i is mode i - half; F is read through
// the caller's order, FFT or symmetric) and every axis's index split as
// i = 8 s + r, r < 8:
//   e(u, i - half) = e(u, 8 s - half) e(u, r),
// each factor from nufft_common.cuh's phase<double> (the torus fold, the
// compensated u k, sincospi; where P::kCarry, d=1, phase_split<double>,
// the rounding error of t = x h carried into every phase).  The reduction
// runs in k-steps of 8 indices k; a point makes the 8 factors e(u, r) of
// each axis once a block and one factor of each k-step (P::chunk_factors):
//  - d=2: e(u2, 8 s - half), k-step s of the modes k;
//  - d=3: k-step (j2, s) holds the modes j3 = 8 s + r (j3 padded to whole
//    k-steps: 21 -> 24), its factor e2(j2) e(u3, 8 s - half), where e2(j2)
//    = e(u2, 8 (j2 / 8) - half) e(u2, j2 % 8) is made once a chunk of
//    k-steps for each j2 the chunk reaches;
//  - d=1: the axes are one coordinate twice, u for the modes r and K u
//    (exact: K is a power of two) for the values q, whose k-step s has the
//    factor e(K u, qmin + 8 s), so that e(K u, qmin + 8 s) e(K u, r') is
//    the mode K (qmin + 8 s + r');
// then A's entry is one complex product, the k-step's factor times
// e(u_A, r) (u2 at d=2, u3 at d=3, K u at d=1).  e1's factors e(u1, 8 s +
// base) (base -half, at d=1 0) are made once a block up to 47 columns a
// vector (past that one a run of up to 8 columns j of a vector in an
// epilogue pass).  The twins (ops/cuda_nufft.py nufft2_2d_f64_tc_ref,
// nufft2_3d_f64_tc_ref, nufft2_1d_f64_tc_ref) form every phase the same
// way.
//
// Operands:
//  - A = eA (points x k) is made on chip, in fragment order, into shared
//    memory: a chunk of P::kChunk k-steps at once (d=2: 6, 48 modes; d=3:
//    4, whose shared memory also holds e2's and e3's fine factors), each
//    thread making whole fragment quads (points g, g + 8 at indices t,
//    t + 4 of a k-step), stored as two 16-byte halves so that a fragment
//    load is two conflict-free 16-byte loads.  Where the reduction takes
//    one such chunk (d=2 up to mtot 47) A is made once a block and kept
//    for every column tile; past that each chunk is made again for every
//    tile (at d=3 always: 63 k-steps at mtot 21, 8 160 at 255).
//  - B = F (k x columns (b, j), column b mc + j, mc = P::epi_cols: mtot,
//    at d=1 K: the vectors' columns follow each other with no padding, the
//    last tile's padded with zeros)
//    is laid out once a call by type2_f64_split_kernel into a scratch in
//    fragment order, [tile][k-step][n-tile][Re, Im][lane][2], the indices
//    k padded with zeros to whole k-steps of 8 (mtot 17 pads to 24, not to
//    32); a block copies it per stage of T2D_KST k-steps with cp.async into
//    one of two buffers while the other is multiplied.  At d=2 it stays in
//    the L2 (11 x 43^2 x 16 B = 325 KB at PG's spatial batch); at d=3 it is
//    the size of f (267 MB at mtot 255), and the blocks of a wave walk it
//    in the same order, so that one's copy brings a stage into the L2 for
//    the others.
//
// Block: 256 threads, P = 64 points, walking every column tile of NC
// columns (64, or 32 where 64 pads the columns 1.25x as far: a single
// vector on a narrow grid) in order; 8 warps in a WR x WC grid of 32 x 16
// (NC 64) or 16 x 16 (NC 32) warp tiles, four m16n8k8 DMMA a 16 x 8 tile
// and k-step.  One role: the phases, the products and the epilogue of a
// block take turns, and two blocks share an SM (at most 113 KB of shared
// memory and 128 registers a thread each), so that one's products may run
// beside the other's phases and epilogue.  Taken apart on the card
// (scripts/time_type2_2d_f64.py --ablate: no DMMA, no epilogue, neither,
// one block an SM) at PG's 1e5 x 17, B 11 the three parts add rather than
// overlap: ~0.067 ms of DMMA, ~0.048 of epilogue, ~0.053 of the rest (the
// phases, F's copies from the L2, the block's prologue and barriers) in
// 0.168; one block an SM takes 1.4x as long.  scripts/time_type2_3d_f64.py
// takes the d=3 instance apart.
//
// Where P::kSplitK (d=3), grid axis y cuts the chunks of k-steps into as
// many runs of whole chunks (few points: hard3d's 1 000 make 16 blocks),
// each block's epilogue writes its run's sums to a partial of the output,
// and launch_reduce adds the partials in split order.  Where P::kSplitCols
// (d=1), grid axis y cuts the column tiles into as many runs instead (few
// points and many vectors: the samplers' 7 points at B 4 000 make one
// block of points), each block walking its own; a tile holds whole
// vectors (K divides the tile), so each output still has one owner.
//
// The sum, in a fixed order and with no atomics:
//  - T of a column tile in the DMMA accumulators: k-step after k-step from
//    zero (the split's k-steps where split), each adding C Fr then S (-Fi)
//    into the real part and C Fi then S Fr into the imaginary part (the
//    tensor cores add a k-step's 8 products and the accumulator in their
//    own order);
//  - the epilogue, T through shared memory T2D_EC columns a pass: thread
//    (p, q) adds, for each vector b = q (mod 4) of the pass,
//    e1(p, j) T[p, (b, j)] over b's columns there in j order, from zero
//    (fused multiply-adds);
//  - a vector's pass sums added in pass order in the same thread's
//    registers (the vector open at a pass's end is the next pass's first,
//    of the same residue), its total stored once to out[b, p] (or the
//    split's partial): every output has one owner;
//  - the splits' partials added in split order (launch_reduce).
// The same bits on every launch.  ops/cuda_nufft.py type2_2d_geometry
// (float64), type2_2d_single_geometry and type2_3d_geometry (float64) own
// the geometry (points, column tile, indices a stage, splits); the launch
// refuses one it has no instance for, and a scratch shorter than the split
// F and the partials.
//
// The problem type P provides: X, the point's type in x, and coord(x, c),
// its coordinate c < kCoords (c 0: the epilogue's axis, e1; coord(x, c, S)
// where kCarry, whose phases carry the rounding error of each t = coord
// h, kept in Extra's te); kRedCoord, the coordinate of A's fine factors
// e(u, r); kChunk, the k-steps of A made at once; kSplitK and kSplitCols,
// what grid axis y splits, if anything; Extra, shared memory of its own;
// split_ok(m, S), whether S (the launch's split of the mode index, 1 at
// d=2 and d=3) is one it has; epi_cols(m, S), the columns j a vector;
// epi_base(m), the mode of column 0; red_steps(m, S), the reduction's
// k-steps; red_ok(ks, r, m, S), whether index r of k-step ks holds a mode;
// chunk_factors(sm, ks0, kn, m, S, tid), the factors of k-steps ks0 .. ks0
// + kn - 1 into sm.s2 (the caller's barrier follows); coef_index(b, j, k,
// m, S, fo), the place in f of F_b[j, k], or -1 (zero).
#pragma once

#include "tc_type1_f64.cuh"
#include "tc_type2.cuh"

namespace {

constexpr int T2D_THREADS = 256;
constexpr int T2D_P = 64;              // points a block
constexpr int T2D_MT = T2D_P / 16;     // its m-tiles
constexpr int T2D_KST = 2;             // k-steps of F a stage
constexpr int T2D_EC = 32;             // columns of T an epilogue pass
constexpr int T2D_EQ = T2D_THREADS / T2D_P;   // epilogue threads a point
constexpr int T2D_S1 = 6;              // e1's factors e(u1, 8 s + base)
                                       // kept a point (mtot up to 47)

// The warp grid over a T2D_P x NC tile: WR x WC warps of MI 16-row m-tiles
// by NI 8-column n-tiles.
template <int NC>
struct T2dTile {
  static_assert(NC == 32 || NC == 64, "tile widths: 32, 64");
  static constexpr int NT = NC / 8;
  static constexpr int WC = NC == 64 ? 4 : 2;
  static constexpr int WR = T2D_THREADS / 32 / WC;
  static constexpr int WM = T2D_P / WR, WN = NC / WC;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static_assert(T2D_EC % WN == 0, "a warp's columns in one epilogue pass");
};

template <class P, int NC>
struct T2dSmem {
  static constexpr int KCH = P::kChunk;
  static_assert(KCH % T2D_KST == 0, "whole stages a chunk");
  // A's chunk: [k-step][cos, sin][m-tile][half][lane] -> (row g, row g+8)
  // at index t (half 0) or t + 4 (half 1)
  double2 ea[KCH][2][T2D_MT][2][32];
  union {
    // F's stages: [buffer][k-step][n-tile][Re, Im][lane] -> (b0, b1)
    double2 fb[2][T2D_KST][NC / 8][2][32];
    // T_EC columns of a tile's T, the epilogue's (the row stride odd, so
    // that 8 neighbouring points' rows fall on distinct 16-byte banks)
    double2 t[T2D_P][T2D_EC + 1];
  };
  // e(u_c, r) of each coordinate c (a row of 9: 8 neighbouring points'
  // rows on distinct 16-byte banks)
  double2 r[P::kCoords][T2D_P][9];
  double2 s2[T2D_P][KCH];                // the chunk's k-step factors
  double2 s1[T2D_P][T2D_S1];             // e(u1, 8 s + base), to 47 columns
  typename P::Extra ex;                  // the problem's own
  double u[P::kCoords][T2D_P];           // torus coordinates
};

// F (B, ...), the caller's mode order -> the fragment-order scratch
// fs[tile][k-step][n-tile][Re, Im][lane][2] (lane 4 g + t: column g of the
// n-tile, indices t and t + 4 of the k-step), column c = b mc + j (mc =
// P::epi_cols); zero past B, where P holds no mode and in the last tile's
// pad columns.  One thread an entry.
template <class P, int NC>
__global__ void type2_f64_split_kernel(const double2* __restrict__ f, int m,
                                       int nb, int fft_order, int nks,
                                       int ncp, int split,
                                       double* __restrict__ fs) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int kq = nks * 8;
  if (idx >= (long long)kq * ncp) return;
  const int k = (int)(idx % kq), c = (int)(idx / kq);
  const int mc = P::epi_cols(m, split);
  const int b = c / mc, j = c % mc;
  double2 v = make_double2(0.0, 0.0);
  if (b < nb) {
    const long long i = P::coef_index(b, j, k, m, split, fft_order);
    if (i >= 0) v = f[i];
  }
  const int ct = c / NC, cc = c % NC;
  const int lane = (cc % 8) * 4 + (k & 3);
  const size_t base =
      (((size_t)ct * nks + (k >> 3)) * (NC / 8) + cc / 8) * 2;
  fs[((base + 0) * 32 + lane) * 2 + ((k >> 2) & 1)] = v.x;
  fs[((base + 1) * 32 + lane) * 2 + ((k >> 2) & 1)] = v.y;
}

// Copy F's stage of k-steps ks0 .. ks0 + cnt - 1 of column tile ct into
// buf, as one cp.async group
template <int NC>
__device__ __forceinline__ void t2d_load_f(double2 (*buf)[NC / 8][2][32],
                                           const double2* __restrict__ fs,
                                           int nks, int ct, int ks0, int cnt,
                                           int tid) {
  constexpr int PER = NC / 8 * 2 * 32;   // double2 a k-step
  const double2* src = fs + ((size_t)ct * nks + ks0) * PER;
  for (int e = tid; e < cnt * PER; e += T2D_THREADS)
    cp_async16(&buf[0][0][0][0] + e, src + e);
  asm volatile("cp.async.commit_group;\n" ::);
}

// A's chunk ch (k-steps ch KCH ..): P's k-step factors, then each
// thread's fragment quads, zero where P holds no mode
template <class P, int NC>
__device__ __forceinline__ void t2d_make_chunk(T2dSmem<P, NC>& sm, int ch,
                                               int nks, int m, int split,
                                               int tid) {
  constexpr int KCH = P::kChunk;
  const int ks0 = ch * KCH;
  const int kn = min(KCH, nks - ks0);
  P::chunk_factors(sm, ks0, kn, m, split, tid);
  __syncthreads();
  for (int q = tid; q < kn * T2D_MT * 32; q += T2D_THREADS) {
    const int lane = q & 31, mt = (q >> 5) % T2D_MT, ks = (q >> 5) / T2D_MT;
    const int g = lane >> 2, t = lane & 3;
    double2 lo[2], hi[2];   // [cos, sin] of points (g, g + 8)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = t + 4 * hh;
      const bool ok = P::red_ok(ks0 + ks, r, m, split);
      double2 e[2];
#pragma unroll
      for (int gg = 0; gg < 2; ++gg) {
        const int p = mt * 16 + g + 8 * gg;
        e[gg] = ok ? cmul(sm.s2[p][ks], sm.r[P::kRedCoord][p][r])
                   : make_double2(0.0, 0.0);
      }
      (hh ? hi : lo)[0] = make_double2(e[0].x, e[1].x);
      (hh ? hi : lo)[1] = make_double2(e[0].y, e[1].y);
    }
    sm.ea[ks][0][mt][0][lane] = lo[0];
    sm.ea[ks][0][mt][1][lane] = hi[0];
    sm.ea[ks][1][mt][0][lane] = lo[1];
    sm.ea[ks][1][mt][1][lane] = hi[1];
  }
}

// The products of k-step ks (of the chunk in sm.ea: eks) from F's stage
// buffer fbk: Re += C Fr, Re += S (-Fi), Im += C Fi, Im += S Fr
template <class P, int NC>
__device__ __forceinline__ void t2d_kstep(
    const T2dSmem<P, NC>& sm, const double2 (*fbk)[2][32], int eks,
    double (&acc)[T2dTile<NC>::MI][T2dTile<NC>::NI][8], int lane, int wr,
    int wc) {
  using Tile = T2dTile<NC>;
  double fr[Tile::NI][2], fi[Tile::NI][2], nfi[Tile::NI][2];
#pragma unroll
  for (int ni = 0; ni < Tile::NI; ++ni) {
    const int nt = wc / 8 + ni;
    const double2 r = fbk[nt][0][lane], i = fbk[nt][1][lane];
    // b0 (t, g), b1 (t+4, g)
    fr[ni][0] = r.x; fr[ni][1] = r.y;
    fi[ni][0] = i.x; fi[ni][1] = i.y;
    nfi[ni][0] = -i.x; nfi[ni][1] = -i.y;
  }
  // one m-tile's A fragments at a time (a0 (g, t), a1 (g+8, t), a2 (g,
  // t+4), a3 (g+8, t+4)), so that two blocks' registers fit an SM
#pragma unroll
  for (int mi = 0; mi < Tile::MI; ++mi) {
    const int mt = wr / 16 + mi;
    const double2 c0 = sm.ea[eks][0][mt][0][lane];
    const double2 c1 = sm.ea[eks][0][mt][1][lane];
    const double ca[4] = {c0.x, c0.y, c1.x, c1.y};
#pragma unroll
    for (int ni = 0; ni < Tile::NI; ++ni) {
      mma_f64(&acc[mi][ni][0], ca, fr[ni]);
      mma_f64(&acc[mi][ni][4], ca, fi[ni]);
    }
    const double2 s0 = sm.ea[eks][1][mt][0][lane];
    const double2 s1 = sm.ea[eks][1][mt][1][lane];
    const double sa[4] = {s0.x, s0.y, s1.x, s1.y};
#pragma unroll
    for (int ni = 0; ni < Tile::NI; ++ni) {
      mma_f64(&acc[mi][ni][0], sa, nfi[ni]);
      mma_f64(&acc[mi][ni][4], sa, fr[ni]);
    }
  }
}

// cos and sin of 2 pi times point p's phase at mode k of coordinate c
// (the rounding error of its t carried in where P::kCarry)
template <class P, class S>
__device__ __forceinline__ void t2d_phase(const S& sm, int c, int p, double k,
                                          double* cs, double* sn) {
  if constexpr (P::kCarry)
    phase_split(sm.u[c][p], sm.ex.te[c][p], k, cs, sn);
  else
    phase(sm.u[c][p], k, cs, sn);
}

template <class P, int NC>
__global__ void __launch_bounds__(T2D_THREADS, 2)
type2_f64_kernel(const typename P::X* __restrict__ x,
                 const double2* __restrict__ fs, double h, int n, int m,
                 int nb, int nks, int split, double2* __restrict__ out) {
  using Tile = T2dTile<NC>;
  using Smem = T2dSmem<P, NC>;
  constexpr int MI = Tile::MI, NI = Tile::NI, KCH = P::kChunk;
  constexpr int NR = 8 * P::kCoords;   // the fine factors a point
  extern __shared__ double2 t2d_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(t2d_smem);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * T2D_P;
  const int base = P::epi_base(m);        // the mode of column j = 0
  const int mc = P::epi_cols(m, split);   // columns j a vector
  const int nj = (mc + 7) / 8;   // e1's factors e(u1, 8 s + base)

  // the points' torus coordinates, then the factors e(u, r) of every axis
  // and, where the columns j take at most T2D_S1 k-steps, e1's factors
  // e(u1, 8 s + base)
  if (tid < T2D_P) {
    const typename P::X xp =
        p0 + tid < n ? x[p0 + tid] : typename P::X{};
#pragma unroll
    for (int c = 0; c < P::kCoords; ++c) {
      if constexpr (P::kCarry)
        sm.u[c][tid] = torus_split(P::coord(xp, c, split), h,
                                   &sm.ex.te[c][tid]);
      else
        sm.u[c][tid] = torus(P::coord(xp, c), h);
    }
  }
  __syncthreads();
  const bool s1_kept = nj <= T2D_S1;
  for (int e = tid; e < T2D_P * (NR + T2D_S1); e += T2D_THREADS) {
    const int p = e / (NR + T2D_S1), q = e % (NR + T2D_S1);
    double c, sn;
    if (q < NR) {
      t2d_phase<P>(sm, q >> 3, p, (double)(q & 7), &c, &sn);
      sm.r[q >> 3][p][q & 7] = make_double2(c, sn);
    } else if (s1_kept && q - NR < nj) {
      t2d_phase<P>(sm, 0, p, (double)(8 * (q - NR) + base), &c, &sn);
      sm.s1[p][q - NR] = make_double2(c, sn);
    }
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wr = (warp / Tile::WC) * Tile::WM;
  const int wc = (warp % Tile::WC) * Tile::WN;
  // the block's k-steps kb .. ke - 1: all, or where P::kSplitK the run of
  // whole chunks of grid row y, whose sums go to partial y of the output
  int kb = 0, ke = nks;
  if constexpr (P::kSplitK) {
    const int per = ((nks + KCH - 1) / KCH + gridDim.y - 1) / gridDim.y;
    kb = blockIdx.y * per * KCH;
    ke = min(nks, kb + per * KCH);
    out += (size_t)blockIdx.y * nb * n;
  }
  const int nchunks = (ke - kb + KCH - 1) / KCH;
  const int nst = (ke - kb + T2D_KST - 1) / T2D_KST;
  const int ncols = nb * mc;
  // the block's column tiles ct0 .. ct1 - 1: all, or where P::kSplitCols
  // the run of grid row y
  int ct0 = 0, ct1 = (ncols + NC - 1) / NC;
  if constexpr (P::kSplitCols) {
    static_assert(!P::kSplitK, "one split of grid axis y");
    const int per = (ct1 + gridDim.y - 1) / gridDim.y;
    ct0 = blockIdx.y * per;
    ct1 = min(ct1, ct0 + per);
  }
  // the epilogue's point and residue of vectors, and its open vector's sum
  const int ep = tid % T2D_P, eq = tid / T2D_P;
  double2 carry = make_double2(0.0, 0.0);

  for (int ct = ct0; ct < ct1; ++ct) {
    double acc[MI][NI][8];   // T: [m-tile][n-tile][re 4, im 4]
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int b = 0; b < NI; ++b)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][b][c] = 0.0;
    t2d_load_f<NC>(sm.fb[0], fs, nks, ct, kb, min(T2D_KST, ke - kb), tid);
    for (int st = 0; st < nst; ++st) {
      const int ks0 = kb + st * T2D_KST;
      // a new chunk of A (the last stage's products are done: the
      // barrier that ended it)
      if ((ks0 - kb) % KCH == 0 && (nchunks > 1 || ct == ct0))
        t2d_make_chunk<P, NC>(sm, ks0 / KCH, nks, m, split, tid);
      if (st + 1 < nst) {
        t2d_load_f<NC>(sm.fb[(st + 1) & 1], fs, nks, ct, ks0 + T2D_KST,
                       min(T2D_KST, ke - ks0 - T2D_KST), tid);
        cp_async_wait<1>();   // all but the next stage's copy
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int kn = min(T2D_KST, ke - ks0);
#pragma unroll
      for (int kk = 0; kk < T2D_KST; ++kk)
        if (kk < kn)
          t2d_kstep<P, NC>(sm, sm.fb[st & 1][kk], (ks0 + kk) % KCH, acc,
                           lane, wr, wc);
      __syncthreads();   // this F buffer, and A's chunk, are free again
    }
    // the epilogue, T2D_EC columns a pass: the pass's T to shared memory
    // (C fragment c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)),
    // then thread (ep, eq) sums, for point ep, each vector b = eq (mod
    // T2D_EQ) of the pass over its columns there, in j order, from zero,
    // and adds that to the vector's sum over its earlier passes (carry: the
    // vector open at a pass's end is the next pass's first, the same
    // thread's); a vector's sum goes to out at its last column
#pragma unroll
    for (int hf = 0; hf < NC / T2D_EC; ++hf) {
      if (wc / T2D_EC == hf) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = wr + mi * 16 + gq + (i >> 1) * 8;
              const int col = wc - hf * T2D_EC + ni * 8 + 2 * tq + (i & 1);
              sm.t[row][col] =
                  make_double2(acc[mi][ni][i], acc[mi][ni][4 + i]);
            }
      }
      __syncthreads();
      const int e0 = ct * NC + hf * T2D_EC;
      const int b_first = e0 / mc;
      const int b_end = min(nb, (e0 + T2D_EC + mc - 1) / mc);
      if (p0 + ep < n) {
        for (int b = b_first + (eq - b_first % T2D_EQ + T2D_EQ) % T2D_EQ;
             b < b_end; b += T2D_EQ) {
          const int ja = max(0, e0 - b * mc);
          const int jb = min(mc, e0 + T2D_EC - b * mc);
          double sr = 0.0, si = 0.0;
          // the columns j a factor e(u1, 8 s + base) at a time
          for (int j0 = ja & ~7; j0 < jb; j0 += 8) {
            double2 sf;
            if (s1_kept) {
              sf = sm.s1[ep][j0 >> 3];
            } else {
              double c, sn;
              t2d_phase<P>(sm, 0, ep, (double)(j0 + base), &c, &sn);
              sf = make_double2(c, sn);
            }
            const int lo = ja - j0, hi = jb - j0;
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              if (r >= lo && r < hi) {
                const double2 e1 = cmul(sf, sm.r[0][ep][r]);
                const double2 tv = sm.t[ep][b * mc + j0 + r - e0];
                sr = fma(-e1.y, tv.y, fma(e1.x, tv.x, sr));
                si = fma(e1.y, tv.x, fma(e1.x, tv.y, si));
              }
            }
          }
          if (ja > 0) {   // not the vector's first pass
            sr = __dadd_rn(carry.x, sr);
            si = __dadd_rn(carry.y, si);
          }
          if (jb == mc)
            out[(size_t)b * n + p0 + ep] = make_double2(sr, si);
          else
            carry = make_double2(sr, si);
        }
      }
      __syncthreads();   // T's buffer is free
    }
  }
}

template <class P, int NC>
int launch_type2_f64_cols(const void* x, const void* f, double h, int n,
                          int m, int nb, int fft_order, int split,
                          int splits, void* scratch,
                          long long scratch_doubles, void* out,
                          cudaStream_t s) {
  const int nks = P::red_steps(m, split);
  const long long ncp =
      ((long long)nb * P::epi_cols(m, split) + NC - 1) / NC * NC;
  const long long fsz = ncp * nks * 8 * 2;
  // the k-splits' partials (P::kSplitK); column splits write the output
  const long long psz =
      splits > 1 && P::kSplitK ? 2LL * splits * nb * n : 0;
  if (fsz + psz > scratch_doubles || (long long)nb * n >= (1LL << 31) ||
      ncp >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long cells = ncp * nks * 8;
  type2_f64_split_kernel<P, NC>
      <<<(unsigned)((cells + 255) / 256), 256, 0, s>>>(
          (const double2*)f, m, nb, fft_order, nks, (int)ncp, split,
          (double*)scratch);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  // two blocks an SM (the launch bounds hold each to 128 registers a thread)
  constexpr int smem = sizeof(T2dSmem<P, NC>);
  static_assert(2 * (smem + 1024) <= 233472, "two blocks an SM");
  err = (int)cudaFuncSetAttribute(type2_f64_kernel<P, NC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err == 0)
    err = (int)cudaFuncSetAttribute(
        type2_f64_kernel<P, NC>, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  if (err != 0) return err;
  double2* dst = psz > 0 ? (double2*)((double*)scratch + fsz)
                          : (double2*)out;
  const dim3 grid((n + T2D_P - 1) / T2D_P, splits);
  type2_f64_kernel<P, NC><<<grid, T2D_THREADS, smem, s>>>(
      (const typename P::X*)x, (const double2*)scratch, h, n, m, nb, nks,
      split, dst);
  err = (int)cudaGetLastError();
  if (err != 0 || psz == 0) return err;
  return launch_reduce<double>(dst, splits, nb * n, out, s);
}

// The caller's geometry (points a block, columns a tile, indices k a
// stage, the split S of the mode index (1 but at d=1), splits of the
// chunks of k-steps (P::kSplitK) or of the column tiles (P::kSplitCols,
// whose tiles hold whole vectors), one where P has neither, none empty)
// checked against the instances there are, and the scratch
// (scratch_doubles doubles) against what it must hold: the split F, then,
// for two k-splits or more, their partials (splits x nb x n values); then
// the split, the kernel and the partials' sum in split order
template <class P>
int launch_type2_f64(const void* x, const void* f, double h, int n, int m,
                     int nb, int fft_order, int points, int cols, int stage,
                     int split, int splits, void* scratch,
                     long long scratch_doubles, void* out, void* stream) {
  if (points != T2D_P || stage != T2D_KST * 8 || splits < 1 ||
      (splits > 1 && !P::kSplitK && !P::kSplitCols) ||
      !P::split_ok(m, split) || (cols != 32 && cols != 64) ||
      (P::kSplitCols && cols % P::epi_cols(m, split) != 0))
    return (int)cudaErrorInvalidValue;
  // what a split cuts: column tiles, or chunks of k-steps
  const int units =
      P::kSplitCols
          ? (int)(((long long)nb * P::epi_cols(m, split) + cols - 1) / cols)
          : (P::red_steps(m, split) + P::kChunk - 1) / P::kChunk;
  const int per = (units + splits - 1) / splits;   // units a split
  if ((units + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cols == 32)
    return launch_type2_f64_cols<P, 32>(x, f, h, n, m, nb, fft_order, split,
                                        splits, scratch, scratch_doubles,
                                        out, s);
  return launch_type2_f64_cols<P, 64>(x, f, h, n, m, nb, fft_order, split,
                                      splits, scratch, scratch_doubles, out,
                                      s);
}

}  // namespace
