// The float32 type-2 NUFFT on the tensor cores, shared by nufft_2d.cu (the
// d=2 type-2, batched and at B 1 for the single), nufft_1d.cu (the d=1
// type-2 on a split of its mode index) and nufft_3d.cu (the d=3 type-2):
// one kernel, type2_tc_kernel<P, NT>, whose problem type P says what its
// reduction modes, its columns and its point coordinates are.
//
// For the block's P points (e = e^{+2 pi i c}, complex):
//   T[p, (b, j)] = sum_k eA(p, k) F_b[j, k]      a GEMM over the modes k,
//   out[b, p]    = sum_j eE(p, j) T[p, (b, j)]   in its epilogue,
// as four real products:
//   T_re = C Fr + S (-Fi),   T_im = C Fi + S Fr   (C, S: cos, sin of eA).
// Each real operand is split into big = cvt.rna.tf32(a) and
// small = cvt.rna.tf32(a - big) (3xTF32), and each real product taken as
// small*big + big*small + big*big on mma.sync.m16n8k8 TF32 fragments, as
// in the type-1 (tc_type1.cuh).
//
// The problems (P):
//  - d=2 (nufft_2d.cu Type2Grid2D; gpquad's _type2_kernel_b,
//    pallas_nufft.py:809-833, is itself this product): k the modes of the
//    second axis (eA = e2 from x2), j those of the first (eE = e1 from x1),
//    F_b[j, k] the vector's coefficients; the modes k and each vector's
//    columns padded to a multiple of 32;
//  - d=1 (nufft_1d.cu Type2Split1D): the mode index split as k = K q + r
//    with K = 32, so that the reduction runs over q (eA = e^{+2 pi i K q t})
//    and the epilogue over r (eE = e^{+2 pi i r t}); F_b[r, q] = f_b[K q +
//    r], zero where K q + r falls outside the mtot modes, so nothing is
//    cropped; each point makes K + Q phases, not mtot, each from the torus
//    coordinate and the rounding error of t = x*h (phase_split).  The q
//    are padded to whole k-steps of 8 only: a stage of 32 modes may end
//    early;
//  - d=3 (nufft_3d.cu Type2Grid3D): k the pairs (j2, j3), j3 padded to a
//    multiple of 32 so that a stage is one j2 and 32 modes j3; eA = e2 e3,
//    a product of two folded phases from a per-stage phase source (below);
//    j the modes of the first axis (eE = e1); the reduction may be split
//    over a grid axis for few points (P::kSplitK, below).
//
// Operands:
//  - A = eA (points x modes) is made on chip and never written to device
//    memory: per stage of T2C_KS modes, each thread makes whole A fragments
//    (t2c_make_quad: the phases of points g, g + 8 at modes t, t + 4) and
//    stores them split, in fragment order, into shared memory, so that a
//    fragment is one 16-byte load and store (a row-major stage cost four
//    register moves per mma).  eA for all modes does not fit there (P x
//    modes x 16 bytes), so it is made again for every column tile.
//  - B = F (modes x columns) is split once per call by
//    type2_split_kernel into a scratch of big and small planes, laid out
//    so that a stage of a column tile is contiguous (cp.async copies it) and
//    a thread's fragment pair and both parts are one 16-byte load.  The
//    columns are (b, j), each vector's padded to mq (a multiple of the
//    epilogue's chunk); at d=2, B 10 and mtot 339 the scratch takes 20 MB,
//    which stays in the L2.
//  - The per-stage phase source (P::kStagePhases, d=3): eA(p, k) =
//    eO(p, st) eI(p, k % 32), an outer phase at one mode a stage st and an
//    inner phase at one of 32 modes that repeat over a run of stages.  A
//    thread's A quads are the same two points g, g + 8 and the same modes
//    of a stage in every stage, so it keeps their inner phases in its own
//    slots of shared memory (T2cStaged, after T2cSmem), remade when the
//    run changes, and makes its two points' outer phase once a stage: two
//    phases and eight complex products a stage and thread, where the
//    others make eight phases (t2c_make_staged).
//
// Block: 512 threads, P = 128 points, walking every column tile of NT
// columns in order (NT 128, or 32 where one vector has 32 columns: the d=1
// split at B 1; at d=3 32 or 64, whose shared memory leaves room for the
// per-stage phase source's 33 KB); 16 warps in an 8 x 2 grid of 16 x NT/2
// warp tiles (one m-tile by NT/16 n-tiles).  A stage: start the copy of F's
// next stage into the other buffer (cp.async), make eA's, wait for this
// stage's F, multiply; one role, so the phases and the products of a block
// do not overlap.  Where P::kSplitK, grid axis y cuts the stages into as
// many runs of whole stages, each block's epilogue writes its run's sums
// to a partial of the output, and launch_reduce adds the partials in split
// order.  scripts/time_type2_batched.py takes the d=2 instance apart on
// the card (most of its time at scale is the products; mma.sync TF32
// reaches only part of the dense rate), scripts/time_type2_1d.py the d=1
// instance, scripts/time_type2_3d.py the d=3 one.
//
// The sum, in a fixed order and with no atomics:
//  - a k-step's 8 modes in the mma accumulators, one chain of six mma
//    started from zero (Hopper's tensor cores do not round their fp32 sums
//    to nearest; longer chains biased the f32 gradient, see tc_type1.cuh);
//  - the k-steps added in fp32 registers, giving T;
//  - the epilogue: T goes to shared memory; thread (p, q) adds
//    eE(p, j) T[p, (b, j)] over the tile's q-th chunk of NT / 4 columns
//    (one vector b), in j order, from zero;
//  - thread p adds the chunks into out[b, p] in column order (the first
//    chunk of a vector stores): each output has one owner, so the result
//    is the same bit for bit on every launch.
//
// Bound: 3 x 8 flops per point, mode and vector on the tensor cores (495
// TFLOP/s dense TF32); the phases (eA once per column tile, eE once per
// column) and the epilogue on the CUDA cores; F's scratch read from the L2
// once per block.
//
// The caller owns the geometry (ops/cuda_nufft.py type2_2d_geometry,
// type2_1d_geometry, type2_3d_geometry) and the launch refuses one it has
// no instance for.
//
// The problem type P provides: X, the point's type in x; point(x, h, &a,
// &b), its two coordinates; red_mode(k, m, fft_order, &ok) and
// red_phase(a, b, kv, &c, &s), the mode value of reduction index k (ok: it
// has coefficients) and cos and sin of 2 pi times its phase in cycles;
// epi_cols(m), the columns of a vector that hold coefficients;
// epi_phase(a, b, j, m, fft_order, &c, &s), the phase of column j;
// red_len(m) and cols(m), the reduction length (whole k-steps) and a
// vector's columns in the scratch (whole epilogue chunks of every tile
// width); kWholeStages, whether red_len is always a whole number of
// stages (then every stage runs the same unrolled code); coef(f, b, j, k,
// m, fft_order), F_b[j, k] or zero; kStagePhases and kSplitK, compile-time
// switches of the per-stage phase source and the split reduction.  With
// kStagePhases (and whole stages) P provides instead of point, red_mode
// and red_phase: point(x, h, &a, &b, &c), three coordinates;
// inner_run(st, m), the run of stage st; inner_mode(run, kk, m, fft_order,
// &ok), the inner mode value at position kk of the run's stages (ok: it
// has coefficients); outer_mode(st, m, fft_order); inner_phase and
// outer_phase(a, b, c, kv, &c, &s); prod(e, f, &c, &s), the product of two
// phases.
#pragma once

#include "tc_type1.cuh"

namespace {

constexpr int T2C_THREADS = 512;
constexpr int T2C_P = 128;         // points a block
constexpr int T2C_KS = 32;         // modes k a stage
constexpr int T2C_WM = 8;          // warps along the points
constexpr int T2C_EQ = T2C_THREADS / T2C_P;   // epilogue threads a point
static_assert(T2C_P / 16 * (T2C_KS / 8) * 32 % T2C_THREADS == 0,
              "whole quads of eA a thread");
// eA's quads a thread a whole stage
constexpr int T2C_NQ = T2C_P / 16 * (T2C_KS / 8) * 32 / T2C_THREADS;

template <int NT>
struct T2cTile {
  static_assert(NT == 32 || NT == 64 || NT == 128,
                "tile widths: 32, 64, 128");
  static constexpr int CHUNK = NT / T2C_EQ;   // columns of an epilogue sum
  static constexpr int TS = NT + 1;  // T's row stride (float2): odd, so a
                                     // warp's 32 points read 32 banks
};

template <int NT>
struct T2cStage {
  // eA in fragment order: [k-step][cos, sin][big, small][m-tile][lane][reg],
  // so that a thread's A fragment is one 16-byte load
  unsigned a[T2C_KS / 8][2][2][T2C_P / 16][32][4];
  float b[2][T2C_KS / 8][2][NT][16];   // F, two buffers:
                                       // [k-step][Re, Im][column]
};

template <int NT>
struct T2cSmem {
  union {
    T2cStage<NT> st;
    float2 t[T2C_P][T2cTile<NT>::TS];   // the column tile's T, epilogue
  };
  float2 red[T2C_EQ][T2C_P];   // the chunks' sums
  float ua[T2C_P], ub[T2C_P];  // the points' coordinates (P::point)
};

// The per-stage phase source's shared memory (P::kStagePhases), after
// T2cSmem: each thread's quads' inner phases, which only that thread
// writes and reads ([quad][register][thread]: a warp's loads are
// contiguous), and the points' third coordinates
struct T2cStaged {
  float2 inner[T2C_NQ][4][T2C_THREADS];
  float uc[T2C_P];
};

// Where mode kk (0-7) of a k-step and part (0 big, 1 small) sit in F's
// group of 16 floats: a thread's fragment pair (kk = t, t + 4) and both
// parts are the float4 at 4 t.
__device__ __forceinline__ int t2c_pos(int kk, int part) {
  return (kk & 3) * 4 + part * 2 + (kk >> 2);
}

// One A fragment (4 tf32 values) from shared memory
__device__ __forceinline__ void t2c_afrag(const unsigned* src,
                                          unsigned (&o)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy F's stage at modes k0.. (nks k-steps) of the column tile c0.. (per
// k-step and part NT columns x 16 floats, contiguous in fs) into buf, as
// one cp.async group
template <int NT>
__device__ __forceinline__ void t2c_load_f(float (*buf)[2][NT][16],
                                           const float4* __restrict__ fs,
                                           int ncp, int c0, int k0, int nks,
                                           int tid) {
  constexpr int ROW4 = NT * 4;   // float4 a (k-step, part)
#pragma unroll
  for (int e = tid; e < T2C_KS / 8 * 2 * ROW4; e += T2C_THREADS) {
    const int r = e / ROW4, q4 = e % ROW4;
    if (r < 2 * nks)
      cp_async16(reinterpret_cast<float4*>(&buf[r >> 1][r & 1][0][0]) + q4,
                 fs + ((size_t)(k0 / 8 * 2 + r) * ncp + c0) * 4 + q4);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// F (the problem's coefficients) -> the split scratch
// fs[k-step][Re, Im][column][16], column (b, j) at b mq + j, zero where P
// has no coefficient, past B and in the ncp - B mq pad columns.  One thread
// per (mode k, column), k fastest.
template <class P>
__global__ void type2_split_kernel(const float2* __restrict__ f, int m,
                                   int nb, int fft_order, int kq, int mq,
                                   int ncp, float* __restrict__ fs) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)kq * ncp) return;
  const int k = (int)(idx % kq), col = (int)(idx / kq);
  const int b = col / mq, j = col % mq;
  float2 v = make_float2(0.f, 0.f);
  if (b < nb) v = P::coef(f, b, j, k, m, fft_order);
  unsigned rb, rs, ib, is;
  split3(v.x, &rb, &rs);
  split3(v.y, &ib, &is);
  const int ks = k >> 3, kk = k & 7;
  float* re = fs + ((size_t)(ks * 2) * ncp + col) * 16;
  float* im = fs + ((size_t)(ks * 2 + 1) * ncp + col) * 16;
  re[t2c_pos(kk, 0)] = __uint_as_float(rb);
  re[t2c_pos(kk, 1)] = __uint_as_float(rs);
  im[t2c_pos(kk, 0)] = __uint_as_float(ib);
  im[t2c_pos(kk, 1)] = __uint_as_float(is);
}

// An A-fragment quad of eA's stage, lane 4 g + t of m-tile mt and k-step
// ks: registers a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4) of cos
// and sin, each split, one 16-byte store a part
template <int NT>
__device__ __forceinline__ void t2c_store_quad(T2cSmem<NT>& sm, int ks,
                                               int mt, int lane,
                                               const float (&c)[4],
                                               const float (&s)[4]) {
  uint4 cb, cs, sb, ss;
  split3(c[0], &cb.x, &cs.x);
  split3(c[1], &cb.y, &cs.y);
  split3(c[2], &cb.z, &cs.z);
  split3(c[3], &cb.w, &cs.w);
  split3(s[0], &sb.x, &ss.x);
  split3(s[1], &sb.y, &ss.y);
  split3(s[2], &sb.z, &ss.z);
  split3(s[3], &sb.w, &ss.w);
  *reinterpret_cast<uint4*>(sm.st.a[ks][0][0][mt][lane]) = cb;
  *reinterpret_cast<uint4*>(sm.st.a[ks][0][1][mt][lane]) = cs;
  *reinterpret_cast<uint4*>(sm.st.a[ks][1][0][mt][lane]) = sb;
  *reinterpret_cast<uint4*>(sm.st.a[ks][1][1][mt][lane]) = ss;
}

// eA's A-fragment quad q of the stage at modes k0..: lane q % 32 of m-tile
// (q / 32) % (P / 16) and k-step q / (32 P / 16); zero where the mode has
// no coefficients
template <class P, int NT>
__device__ __forceinline__ void t2c_make_quad(T2cSmem<NT>& sm, int q, int k0,
                                              int m, int fft_order) {
  constexpr int MT = T2C_P / 16;
  const int lane = q & 31, mt = (q >> 5) % MT, ks = (q >> 5) / MT;
  const int p = mt * 16 + (lane >> 2), k = k0 + ks * 8 + (lane & 3);
  const float ua[2] = {sm.ua[p], sm.ua[p + 8]};
  const float ub[2] = {sm.ub[p], sm.ub[p + 8]};
  float c[4], s[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kr = k + (r >> 1) * 4;
    bool ok;
    const float kv = P::red_mode(kr, m, fft_order, &ok);
    c[r] = 0.f;
    s[r] = 0.f;
    if (ok) P::red_phase(ua[r & 1], ub[r & 1], kv, &c[r], &s[r]);
  }
  t2c_store_quad<NT>(sm, ks, mt, lane, c, s);
}

// eA's stage st from the per-stage phase source (P::kStagePhases): thread
// tid's quads tid + i T2C_THREADS (i < T2C_NQ) are of the same m-tile
// (points g, g + 8) at k-steps ks_i; their inner phases are remade when
// the stage's run is not `run` (the same for every thread), then each
// register is the product of its point's outer phase and its inner phase
template <class P, int NT>
__device__ __forceinline__ void t2c_make_staged(T2cSmem<NT>& sm,
                                                T2cStaged& sg, int& run,
                                                int st, int m, int fft_order,
                                                int tid) {
  constexpr int MT = T2C_P / 16;
  const int lane = tid & 31, mt = (tid >> 5) % MT;
  const int p = mt * 16 + (lane >> 2);
  const int r0 = P::inner_run(st, m);
  if (r0 != run) {
    run = r0;
#pragma unroll
    for (int i = 0; i < T2C_NQ; ++i) {
      const int ks = ((tid + i * T2C_THREADS) >> 5) / MT;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pp = p + (r & 1) * 8;
        bool ok;
        const float kv = P::inner_mode(r0, ks * 8 + (lane & 3) + (r >> 1) * 4,
                                       m, fft_order, &ok);
        float2 e = make_float2(0.f, 0.f);
        if (ok)
          P::inner_phase(sm.ua[pp], sm.ub[pp], sg.uc[pp], kv, &e.x, &e.y);
        sg.inner[i][r][tid] = e;
      }
    }
  }
  const float ko = P::outer_mode(st, m, fft_order);
  float2 eo[2];
#pragma unroll
  for (int g = 0; g < 2; ++g)
    P::outer_phase(sm.ua[p + 8 * g], sm.ub[p + 8 * g], sg.uc[p + 8 * g], ko,
                   &eo[g].x, &eo[g].y);
#pragma unroll
  for (int i = 0; i < T2C_NQ; ++i) {
    float c[4], s[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      P::prod(eo[r & 1], sg.inner[i][r][tid], &c[r], &s[r]);
    t2c_store_quad<NT>(sm, ((tid + i * T2C_THREADS) >> 5) / MT, mt, lane, c,
                       s);
  }
}

// The products of NKS k-steps of the stage in buffer `buf`: per k-step and
// n-tile one chain of six mma from zero, added into acc
template <int NT, int NKS>
__device__ __forceinline__ void t2c_products(
    const T2cSmem<NT>& sm, int buf,
    float (&acc)[T2C_P / T2C_WM / 16][NT / (T2C_THREADS / 32 / T2C_WM) / 8][8],
    int lane, int wr, int wc, int gq, int tq) {
  constexpr int MI = T2C_P / T2C_WM / 16;
  constexpr int NI = NT / (T2C_THREADS / 32 / T2C_WM) / 8;
  const float(*fb)[2][NT][16] = sm.st.b[buf];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    // A fragments of cos and sin: [m-tile][part][reg]
    unsigned ca[MI][2][4], sa[MI][2][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int mt = wr / 16 + mi;
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        t2c_afrag(sm.st.a[ks][0][part][mt][lane], ca[mi][part]);
        t2c_afrag(sm.st.a[ks][1][part][mt][lane], sa[mi][part]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      // B fragments b0 (t, g), b1 (t+4, g): [part][reg]
      const int col = wc + ni * 8 + gq;
      const uint4 r4 =
          *reinterpret_cast<const uint4*>(&fb[ks][0][col][tq * 4]);
      const uint4 i4 =
          *reinterpret_cast<const uint4*>(&fb[ks][1][col][tq * 4]);
      const unsigned fr[2][2] = {{r4.x, r4.y}, {r4.z, r4.w}};
      const unsigned fi[2][2] = {{i4.x, i4.y}, {i4.z, i4.w}};
      float d[MI][8];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int c = 0; c < 8; ++c) d[mi][c] = 0.f;
      // small*big, big*small, big*big; Re += C Fr + S (-Fi),
      // Im += C Fi + S Fr: one chain of six mma a sum, from zero
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const int pa = pass == 0 ? 1 : 0;     // A's part
        const int pb = pass == 1 ? 1 : 0;     // B's part
        const unsigned nfi[2] = {fi[pb][0] ^ 0x80000000u,
                                 fi[pb][1] ^ 0x80000000u};
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_tf32(&d[mi][0], ca[mi][pa], fr[pb]);
          mma_tf32(&d[mi][4], ca[mi][pa], fi[pb]);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_tf32(&d[mi][0], sa[mi][pa], nfi);
          mma_tf32(&d[mi][4], sa[mi][pa], fr[pb]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[mi][ni][c] = __fadd_rn(acc[mi][ni][c], d[mi][c]);
    }
  }
}

// One stage of NKS k-steps at modes k0.. of the column tile c0..: F's next
// stage (next_nks k-steps, if `more`) into the other buffer while this one
// is used, eA's stage made and split (each thread whole A fragments, the
// quads of lane (g, t) of an m-tile and k-step: points g and g + 8, modes t
// and t + 4, one 16-byte store a part; from the per-stage phase source
// where P::kStagePhases: sg, run), then the products
template <class P, int NT, int NKS>
__device__ __forceinline__ void t2c_stage(
    T2cSmem<NT>& sm,
    float (&acc)[T2C_P / T2C_WM / 16][NT / (T2C_THREADS / 32 / T2C_WM) / 8][8],
    const float4* __restrict__ fs, int ncp, int c0, int k0, bool more,
    int next_nks, int buf, int m, int fft_order, int tid, int lane, int wr,
    int wc, int gq, int tq, T2cStaged* sg, int& run) {
  if (more)
    t2c_load_f<NT>(sm.st.b[buf ^ 1], fs, ncp, c0, k0 + T2C_KS, next_nks, tid);
  if constexpr (P::kStagePhases) {
    static_assert(P::kWholeStages && NKS == T2C_KS / 8,
                  "the per-stage phase source takes whole stages");
    t2c_make_staged<P, NT>(sm, *sg, run, k0 / T2C_KS, m, fft_order, tid);
  } else {
#pragma unroll
    for (int q = tid; q < T2C_P / 16 * NKS * 32; q += T2C_THREADS)
      t2c_make_quad<P, NT>(sm, q, k0, m, fft_order);
  }
  if (more)
    cp_async_wait<1>();   // all but the next stage's copy
  else
    cp_async_wait<0>();
  __syncthreads();
  t2c_products<NT, NKS>(sm, buf, acc, lane, wr, wc, gq, tq);
  __syncthreads();   // eA's buffer and this F buffer are free again
}

template <class P, int NT>
__global__ void __launch_bounds__(T2C_THREADS, 1)
type2_tc_kernel(const typename P::X* __restrict__ x,
                const float4* __restrict__ fs, float h, int n, int m, int nb,
                int fft_order, int kq, int mq, int ncp,
                float2* __restrict__ out) {
  constexpr int CHUNK = T2cTile<NT>::CHUNK;
  extern __shared__ float4 t2c_smem[];
  T2cSmem<NT>& sm = *reinterpret_cast<T2cSmem<NT>*>(t2c_smem);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * T2C_P;
  const int ncols = nb * mq;
  // the per-stage phase source's shared memory, after sm (P::kStagePhases)
  T2cStaged* sg = nullptr;
  if constexpr (P::kStagePhases)
    sg = reinterpret_cast<T2cStaged*>(&sm + 1);
  // epilogue: point ep, chunk eq of the tile; the point's coordinates in
  // registers
  const int ep = tid % T2C_P, eq = tid / T2C_P;
  float ua, ub;
  {
    typename P::X xp = {};
    if (p0 + ep < n) xp = x[p0 + ep];
    if constexpr (P::kStagePhases) {
      float uc;
      P::point(xp, h, &ua, &ub, &uc);
      if (tid < T2C_P) sg->uc[tid] = uc;
    } else {
      P::point(xp, h, &ua, &ub);
    }
    if (tid < T2C_P) {
      sm.ua[tid] = ua;
      sm.ub[tid] = ub;
    }
  }
  // the products: WM x WN warps, warp tile (wr, wc) of MI m-tiles by NI
  // n-tiles, fragment row / column (gq, tq)
  constexpr int WM = T2C_WM, WN = T2C_THREADS / 32 / WM;
  constexpr int MI = T2C_P / WM / 16, NI = NT / WN / 8;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  static_assert(MI * WM * 16 == T2C_P && NI * WN * 8 == NT,
                "the warp grid covers the block's tile");
  const int wr = (warp / WN) * (MI * 16), wc = (warp % WN) * (NI * 8);
  const int nst = (kq + T2C_KS - 1) / T2C_KS;
  // the block's stages st0 .. st1 - 1: all, or where P::kSplitK the
  // run of grid row y (whole stages, none empty: the launch checks), whose
  // sums go to partial y of the output
  int st0 = 0, st1 = nst;
  if constexpr (P::kSplitK) {
    static_assert(P::kWholeStages, "a split takes whole stages");
    const int per = (nst + gridDim.y - 1) / gridDim.y;
    st0 = blockIdx.y * per;
    st1 = min(nst, st0 + per);
    out += (size_t)blockIdx.y * nb * n;
  }
  int run = -1;   // the run whose inner phases sg holds (P::kStagePhases)

  for (int c0 = 0; c0 < ncols; c0 += NT) {
    float acc[MI][NI][8];   // T: [m-tile][n-tile][re 4, im 4]
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int b = 0; b < NI; ++b)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][b][c] = 0.f;
    __syncthreads();   // the buffers are free (the last tile's epilogue)
    t2c_load_f<NT>(sm.st.b[0], fs, ncp, c0, st0 * T2C_KS,
                   P::kWholeStages ? T2C_KS / 8 : min(T2C_KS, kq) / 8, tid);
    for (int st = st0; st < st1; ++st) {
      const int k0 = st * T2C_KS;
      if constexpr (P::kWholeStages) {
        t2c_stage<P, NT, T2C_KS / 8>(sm, acc, fs, ncp, c0, k0, st + 1 < st1,
                                     T2C_KS / 8, (st - st0) & 1, m,
                                     fft_order, tid, lane, wr, wc, gq, tq, sg,
                                     run);
      } else {
        // the last stage of a d=1 split's q may hold 1-3 k-steps
        const int nks = min(T2C_KS, kq - k0) / 8;
        const int next = st + 1 < nst ? min(T2C_KS, kq - k0 - T2C_KS) / 8
                                      : 0;
        if (nks == T2C_KS / 8)
          t2c_stage<P, NT, T2C_KS / 8>(sm, acc, fs, ncp, c0, k0, next > 0,
                                       next, st & 1, m, fft_order, tid, lane,
                                       wr, wc, gq, tq, sg, run);
        else if (nks == 3)
          t2c_stage<P, NT, 3>(sm, acc, fs, ncp, c0, k0, false, 0, st & 1, m,
                              fft_order, tid, lane, wr, wc, gq, tq, sg, run);
        else if (nks == 2)
          t2c_stage<P, NT, 2>(sm, acc, fs, ncp, c0, k0, false, 0, st & 1, m,
                              fft_order, tid, lane, wr, wc, gq, tq, sg, run);
        else
          t2c_stage<P, NT, 1>(sm, acc, fs, ncp, c0, k0, false, 0, st & 1, m,
                              fft_order, tid, lane, wr, wc, gq, tq, sg, run);
      }
    }
    // the epilogue: T to shared memory (C fragment c0 (g, 2t), c1 (g, 2t+1),
    // c2 (g+8, 2t), c3 (g+8, 2t+1))
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wr + mi * 16 + gq + (i >> 1) * 8;
          const int col = wc + ni * 8 + 2 * tq + (i & 1);
          sm.t[row][col] = make_float2(acc[mi][ni][i], acc[mi][ni][4 + i]);
        }
    __syncthreads();
    {
      // chunk eq: one vector's columns j0.. in j order, from zero
      const int cc = c0 + eq * CHUNK;
      const int b = cc / mq, j0 = cc % mq;
      float sr = 0.f, si = 0.f;
      if (b < nb) {
        const int jn = min(CHUNK, P::epi_cols(m) - j0);
        for (int jj = 0; jj < jn; ++jj) {
          float c, s;
          P::epi_phase(ua, ub, j0 + jj, m, fft_order, &c, &s);
          const float2 tv = sm.t[ep][eq * CHUNK + jj];
          // (c + i s)(T_re + i T_im)
          sr = __fadd_rn(sr, fmaf(c, tv.x, -s * tv.y));
          si = __fadd_rn(si, fmaf(c, tv.y, s * tv.x));
        }
      }
      sm.red[eq][ep] = make_float2(sr, si);
    }
    __syncthreads();
    if (tid < T2C_P && p0 + tid < n) {
#pragma unroll
      for (int q = 0; q < T2C_EQ; ++q) {
        const int cc = c0 + q * CHUNK;
        const int b = cc / mq;
        if (b >= nb) break;
        float2* o = out + (size_t)b * n + p0 + tid;
        float2 v = sm.red[q][tid];
        if (cc % mq != 0) {   // not the vector's first chunk: add
          const float2 prev = *o;
          v.x = __fadd_rn(prev.x, v.x);
          v.y = __fadd_rn(prev.y, v.y);
        }
        *o = v;
      }
    }
  }
}

template <class P, int NT>
int launch_type2_tc_cols(const void* x, const void* scratch, float h, int n,
                         int m, int nb, int fft_order, int kq, int mq,
                         int ncp, int splits, void* out, cudaStream_t s) {
  constexpr int smem =
      sizeof(T2cSmem<NT>) + (P::kStagePhases ? sizeof(T2cStaged) : 0);
  int err = (int)cudaFuncSetAttribute(
      type2_tc_kernel<P, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != 0) return err;
  const dim3 grid((n + T2C_P - 1) / T2C_P, splits);
  type2_tc_kernel<P, NT><<<grid, T2C_THREADS, smem, s>>>(
      (const typename P::X*)x, (const float4*)scratch, h, n, m, nb,
      fft_order, kq, mq, ncp, (float2*)out);
  return (int)cudaGetLastError();
}

// The caller's geometry (points a block, columns a tile, modes a stage,
// splits of the stages) checked against the instances there are (tile
// widths WIDTHS: bit 0 for 32, bit 1 for 128, bit 2 for 64; splits only
// where P::kSplitK, none empty), and the scratch (scratch_floats floats)
// against what it must hold: the split F, then, for two splits or more,
// their partials (splits x nb x n values); then the split, the kernel and
// the partials' sum in split order
template <class P, int WIDTHS>
int launch_type2_tc(const void* x, const void* f, float h, int n, int m,
                    int nb, int fft_order, int points, int cols, int stage,
                    int splits, void* scratch, long long scratch_floats,
                    void* out, void* stream) {
  const int bit = cols == 32 ? 1 : cols == 128 ? 2 : cols == 64 ? 4 : 0;
  if (points != T2C_P || stage != T2C_KS || !(bit & WIDTHS))
    return (int)cudaErrorInvalidValue;
  const int kq = P::red_len(m), mq = P::cols(m);
  const long long ncp = ((long long)nb * mq + cols - 1) / cols * cols;
  const int nst = (kq + T2C_KS - 1) / T2C_KS;
  if (splits < 1 || (splits > 1 && !P::kSplitK))
    return (int)cudaErrorInvalidValue;
  const int per = (nst + splits - 1) / splits;   // stages a split
  if ((nst + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
  const long long fsz = ncp * kq * 4;
  const long long psz = splits > 1 ? 2LL * splits * nb * n : 0;
  if (ncp * kq >= (1LL << 31) || fsz + psz > scratch_floats ||
      (long long)nb * n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  type2_split_kernel<P><<<(unsigned)((ncp * kq + 255) / 256), 256, 0, s>>>(
      (const float2*)f, m, nb, fft_order, kq, mq, (int)ncp, (float*)scratch);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  void* dst = splits > 1 ? (void*)((float*)scratch + fsz) : out;
  err = (int)cudaErrorInvalidValue;
  if constexpr ((WIDTHS & 1) != 0)
    if (cols == 32)
      err = launch_type2_tc_cols<P, 32>(x, scratch, h, n, m, nb, fft_order,
                                        kq, mq, (int)ncp, splits, dst, s);
  if constexpr ((WIDTHS & 4) != 0)
    if (cols == 64)
      err = launch_type2_tc_cols<P, 64>(x, scratch, h, n, m, nb, fft_order,
                                        kq, mq, (int)ncp, splits, dst, s);
  if constexpr ((WIDTHS & 2) != 0)
    if (cols == 128)
      err = launch_type2_tc_cols<P, 128>(x, scratch, h, n, m, nb, fft_order,
                                         kq, mq, (int)ncp, splits, dst, s);
  if (err != 0 || splits == 1) return err;
  return launch_reduce<float>(dst, splits, nb * n, out, s);
}

}  // namespace
