// Hand-written Hopper (sm_90a) kernels for the triangular sweeps of the
// stationary methods and of the incomplete-LU preconditioners: S1, the grid
// sweep, and S2, the level-scheduled sweep.
//
// Plain C interface, loaded with ctypes (krylov_tpu_torch/ops/cuda_triangular.py).
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().  Both kernels are instantiated for f32, f64,
// complex64 and complex128, and take every operand in that one type.
//
// Neither replaces a TPU kernel: the reference runs these sweeps as XLA
// loops (krylov_tpu/ops/triangular.py: grid_lower_sweep / grid_upper_sweep,
// a lax.scan over grid rows with an associative_scan across each row;
// StackedTriangularSweep, a lax.scan over padded dependency levels, and
// LevelScheduledTriangularSolve, one XLA stage a level).  They were added
// because the port ran them as Python loops of ~23 launches a grid row or
// ~8 a level, which no CUDA graph can hold at full width; each sweep here is
// one launch (a few for a factor with wide levels).
//
// There are no atomics: every sum is taken in an order fixed by the operands'
// layout, so a sweep repeats bit for bit.  The order differs from the plain
// versions' (a doubling scan across a grid row; products summed by
// segment_reduce), so results agree with them to rounding.
//
// ---------------------------------------------------------------------------
// S1: the grid sweep.  (D/omega + L) x = b on a grid stencil's lower
// triangle, or (D/omega + U) x = b on its upper one, for nrhs right-hand
// sides (M, ny) each.
//
// Bound on this card: the chain of M dependent grid rows, not the bytes
// (b, the coefficient planes and x once each: 5 planes for a 5-point
// stencil, ~100 us at 4096^2 f32 against milliseconds of chain).  One SM
// takes a whole row: on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 8,
// tools/torch_sweeps.py) a 5-point float32 sweep takes 2.0 us a row at
// 1024^2 and 4.3 at 4096^2, that SM's issue of a row's 4096 columns.
//
// Design: one CTA a right-hand side walks the rows in sweep order (row 0 up
// for the lower triangle, row M - 1 down for the upper one).  A thread owns
// `per` consecutive positions of the row in scan order (columns left to
// right for the lower triangle, right to left for the upper one).  For each
// row:
//  A. neighbouring threads on neighbouring columns (every load and store of
//     device memory coalesced) form rhs = b - sum_q plane_q * x[row -
//     back_q, (j + dc_q) mod ny] (the reference's jnp.roll wrap-around; rows
//     before the first read as zero) from a ring of the last h solved rows
//     in shared memory, then c = rhs / d, and leave c and a in shared
//     memory; each thread composes its positions' affine maps
//     x_j = a_j x_{j-1} + c_j into one (A, C).  A row's b, d, a and first
//     band do not depend on x: each thread loads those of its first columns
//     for the next row into registers while it solves this one, so the
//     chain of rows does not wait for device memory;
//  B. a block scan of the threads' maps (shuffles within each warp, warp 0
//     over the warps' totals) gives each thread the x entering its chunk;
//  C. each thread runs its chunk's recurrence from that value into the
//     ring; then the row goes to device memory, coalesced again.
// The rows in shared memory carry a padding element after every 32 values,
// so a warp's reads of its threads' chunks fall on distinct banks.  The
// d == 0 guards (a = 0, divisor 1) and the zero a at the row's first
// position are in the planes `a` and `d` the wrapper prepares once.
// When h + 2 rows do not fit in KRYLOV_SWEEP_SMEM bytes of shared memory (a
// wide row), each thread reads its own chunk's inputs, the solved rows in
// device memory, and its c values wait in the output row itself.  Four
// block barriers a row (three for a wide one).
// ---------------------------------------------------------------------------
//
// S2: the level-scheduled sweep.  x[rows_l] = (b[rows_l] - sum data * x[col])
// / diag_l, level after level, for a factor of n rows and k right-hand sides
// (b and x (n, k), row-major).
//
// Bound on this card: the chain of dependency levels for the narrow levels,
// bytes for the wide ones.
//
// Design: the wrapper orders the factor once on the host into slots (a
// level's rows, level after level), each slot's entries in stored order,
// and cuts the levels into a schedule: consecutive levels of at most
// NARROW_ROWS rows form a run, done by one CTA of KRYLOV_LEVEL_THREADS
// threads with a block barrier between levels; a wider level is a launch of
// its own over many CTAs.  A thread takes one (slot, column) item of a
// level at a time; the row, its diagonal, its b and the first
// KRYLOV_LEVEL_ENTRIES of its entries do not depend on x, so a run loads the
// next level's first item of each thread before it finishes this level's.
// Each row sums its entries in their stored order.  Measured on an H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 8, tools/torch_sweeps.py): ILU(0)
// at 256^2 and 1024^2, one run a factor, 1.0 and 1.9 us a level: the
// level's rows read b and write x at scattered addresses (a grid's
// wavefront is a diagonal), all through one SM.
// ---------------------------------------------------------------------------

#include "krylov_common.cuh"

#define KRYLOV_SWEEP_THREADS 1024
// fewest positions a thread owns: a row of 1024 takes 512 threads, fewer
// warps for the block scan than a thread a position (2.38 against 2.65 us a
// row at 1024^2, 2.72 with 4 positions; tools/torch_sweeps.py --variants)
#ifndef KRYLOV_SWEEP_PER_MIN
#define KRYLOV_SWEEP_PER_MIN 2
#endif
#define KRYLOV_SWEEP_MAX_BANDS 16
// shared memory for the ring of solved rows and the row's c and a values
#ifndef KRYLOV_SWEEP_SMEM
#define KRYLOV_SWEEP_SMEM (200 * 1024)
#endif
#define KRYLOV_LEVEL_THREADS 1024
#define KRYLOV_LEVEL_WIDE_THREADS 256
#ifndef KRYLOV_LEVEL_ENTRIES
#define KRYLOV_LEVEL_ENTRIES 4
#endif

namespace {

template <typename T>
__device__ __forceinline__ T tri_div(T a, T b) { return a / b; }

// Complex division by Smith's scaling, as torch divides complex values.
template <typename R>
__device__ __forceinline__ cplx<R> tri_div(cplx<R> a, cplx<R> b) {
  if (fabs(b.re) >= fabs(b.im)) {
    const R r = b.im / b.re;
    const R d = b.re + b.im * r;
    return cplx<R>((a.re + a.im * r) / d, (a.im - a.re * r) / d);
  }
  const R r = b.re / b.im;
  const R d = b.im + b.re * r;
  return cplx<R>((a.re * r + a.im) / d, (a.im * r - a.re) / d);
}

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  return __shfl_up_sync(0xffffffffu, v, d);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl_up(cplx<R> v, int d) {
  return cplx<R>(__shfl_up_sync(0xffffffffu, v.re, d), __shfl_up_sync(0xffffffffu, v.im, d));
}

// ---------------------------------------------------------------------------
// S1
// ---------------------------------------------------------------------------

// The row bands of the solved side: coefficient plane, rows back in sweep
// order (1..h) and column offset of each.
struct SweepBands {
  int nb;
  int plane[KRYLOV_SWEEP_MAX_BANDS];
  int back[KRYLOV_SWEEP_MAX_BANDS];
  int dc[KRYLOV_SWEEP_MAX_BANDS];
};

// Inclusive scan of affine maps y -> A y + C over a warp's lanes, lane 0
// first: (A, C) after (a', c') is (A a', A c' + C).
template <typename T>
__device__ __forceinline__ void warp_scan_maps(T& A, T& C, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T pa = shfl_up(A, o);
    const T pc = shfl_up(C, o);
    if (lane >= o) {
      C = A * pc + C;
      A = A * pa;
    }
  }
}

// A row in shared memory, one padding element after every 32: a thread's
// consecutive positions (stride `per` across a warp) fall on distinct banks.
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }
__host__ __device__ inline int padded_row(int ny) { return ny + (ny >> 5) + 1; }

template <typename T>
__global__ void __launch_bounds__(KRYLOV_SWEEP_THREADS)
grid_sweep_kernel(const T* __restrict__ coeffs, const T* __restrict__ a,
                  const T* __restrict__ d, const T* __restrict__ b, T* __restrict__ x, int M,
                  int ny, int upper, int h, int per, int in_smem, SweepBands bands) {
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  __shared__ __align__(16) unsigned char warp_maps[2 * 32 * sizeof(T)];
  T* warp_a = reinterpret_cast<T*>(warp_maps);  // each warp's map, then their scan
  T* warp_c = warp_a + 32;
  const int hh = h > 0 ? h : 1;
  const int pr = padded_row(ny);
  T* ring = reinterpret_cast<T*>(sweep_smem);  // hh solved rows, slot s % hh
  T* cbuf = ring + (size_t)hh * pr;            // this row's c, by column
  T* abuf = cbuf + pr;                         // this row's a, by column
  const size_t plane_n = (size_t)M * ny;
  b += blockIdx.x * plane_n;
  x += blockIdx.x * plane_n;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int p0 = min(tid * per, ny);
  const int p1 = min(p0 + per, ny);
  // rhs = b - sum_q plane_q * x[solved row, wrapped column], band 0's
  // coefficient given, the solved rows from the ring
  auto row_rhs = [&](T r, T c0, int s, int slot, size_t row, int j) {
    for (int q = 0; q < bands.nb; ++q) {
      const int back = bands.back[q];
      if (s < back) continue;  // rows before the first read as zero
      int jj = j + bands.dc[q];  // |dc| < ny: one wrap at most
      jj = jj < 0 ? jj + ny : (jj >= ny ? jj - ny : jj);
      const int from = slot - back < 0 ? slot - back + hh : slot - back;
      const T c = q == 0 ? c0 : coeffs[bands.plane[q] * plane_n + row + j];
      r = r - c * ring[(size_t)from * pr + padded(jj)];
    }
    return r;
  };
  // the next row's b, d, a and band 0's coefficient at this thread's first
  // U columns, loaded while this row is solved (U values of each in 16
  // registers: a row of 4096 float32 columns in 1024 threads)
  constexpr int U = sizeof(T) <= 4 ? 4 : (sizeof(T) <= 8 ? 2 : 1);
  T nb_b[U], nb_d[U], nb_a[U], nb_c[U];
  auto fetch = [&](size_t rr) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = tid + u * nt;
      if (j < ny) {
        nb_b[u] = b[rr + j];
        nb_d[u] = d[rr + j];
        nb_a[u] = a[rr + j];
        nb_c[u] = bands.nb > 0 ? coeffs[bands.plane[0] * plane_n + rr + j] : T(0);
      }
    }
  };
  if (in_smem) fetch((size_t)(upper ? M - 1 : 0) * ny);

  for (int s = 0; s < M; ++s) {
    const int i = upper ? M - 1 - s : s;
    const size_t row = (size_t)i * ny;
    const int slot = s % hh;  // this row's slot of the ring
    if (in_smem) {
      // A1: c and a of every column, neighbouring threads on neighbouring
      // columns, the solved rows from the ring; the first U columns of each
      // thread from the registers loaded during the row before
      T cb[U], cd[U], ca[U], cc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cb[u] = nb_b[u];
        cd[u] = nb_d[u];
        ca[u] = nb_a[u];
        cc[u] = nb_c[u];
      }
      if (s + 1 < M) fetch((size_t)(upper ? i - 1 : i + 1) * ny);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = tid + u * nt;
        if (j < ny) {
          const T r = row_rhs(cb[u], cc[u], s, slot, row, j);
          cbuf[padded(j)] = tri_div(r, cd[u]);
          abuf[padded(j)] = ca[u];
        }
      }
      for (int j = tid + U * nt; j < ny; j += nt) {
        const T c0 = bands.nb > 0 ? coeffs[bands.plane[0] * plane_n + row + j] : T(0);
        const T r = row_rhs(b[row + j], c0, s, slot, row, j);
        cbuf[padded(j)] = tri_div(r, d[row + j]);
        abuf[padded(j)] = a[row + j];
      }
      __syncthreads();
    }
    // A2: the composite of this thread's positions' maps (without the ring
    // in shared memory, c is formed here and waits in the output row)
    T A = T(1), C = T(0);
    for (int p = p0; p < p1; ++p) {
      const int j = upper ? ny - 1 - p : p;
      T c, aj;
      if (in_smem) {
        c = cbuf[padded(j)];
        aj = abuf[padded(j)];
      } else {
        T r = b[row + j];
        for (int q = 0; q < bands.nb; ++q) {
          const int back = bands.back[q];
          if (s < back) continue;
          int jj = j + bands.dc[q];
          jj = jj < 0 ? jj + ny : (jj >= ny ? jj - ny : jj);
          r = r - coeffs[bands.plane[q] * plane_n + row + j] *
                      x[(size_t)(upper ? i + back : i - back) * ny + jj];
        }
        c = tri_div(r, d[row + j]);
        aj = a[row + j];
        x[row + j] = c;
      }
      A = aj * A;
      C = aj * C + c;
    }
    // B: the x entering this thread's chunk
    warp_scan_maps(A, C, lane);
    if (lane == 31) {
      warp_a[warp] = A;
      warp_c[warp] = C;
    }
    __syncthreads();
    if (warp == 0) {
      T wa = lane < nwarps ? warp_a[lane] : T(1);
      T wc = lane < nwarps ? warp_c[lane] : T(0);
      warp_scan_maps(wa, wc, lane);
      warp_a[lane] = wa;
      warp_c[lane] = wc;
    }
    __syncthreads();
    const T xw = warp > 0 ? warp_c[warp - 1] : T(0);
    const T pa = shfl_up(A, 1);
    const T pc = shfl_up(C, 1);
    T xv = lane > 0 ? pa * xw + pc : xw;
    // C: the chunk's recurrence, into the ring (or the output row)
    T* out = in_smem ? ring + (size_t)slot * pr : nullptr;
    for (int p = p0; p < p1; ++p) {
      const int j = upper ? ny - 1 - p : p;
      if (in_smem) {
        xv = abuf[padded(j)] * xv + cbuf[padded(j)];
        out[padded(j)] = xv;
      } else {
        xv = a[row + j] * xv + x[row + j];
        x[row + j] = xv;
      }
    }
    __syncthreads();
    if (in_smem) {
      // D: the row to device memory, neighbouring threads on neighbouring columns
      for (int j = tid; j < ny; j += nt) x[row + j] = out[padded(j)];
    }
  }
}

template <typename T>
int launch_grid_sweep(const void* coeffs, const void* a, const void* d, const void* b, void* x,
                      int nrhs, int M, int ny, int upper, int h, const SweepBands& bands,
                      cudaStream_t s) {
  int per = (ny + KRYLOV_SWEEP_THREADS - 1) / KRYLOV_SWEEP_THREADS;
  if (per < KRYLOV_SWEEP_PER_MIN) per = KRYLOV_SWEEP_PER_MIN;
  int threads = (ny + per - 1) / per;
  threads = (threads + 31) / 32 * 32;
  const size_t want = (size_t)((h > 0 ? h : 1) + 2) * padded_row(ny) * sizeof(T);
  const int in_smem = want <= KRYLOV_SWEEP_SMEM;
  const int smem = in_smem ? (int)want : 0;
  const auto kernel = grid_sweep_kernel<T>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nrhs, threads, smem, s>>>(static_cast<const T*>(coeffs), static_cast<const T*>(a),
                                     static_cast<const T*>(d), static_cast<const T*>(b),
                                     static_cast<T*>(x), M, ny, upper, h, per, in_smem, bands);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// S2
// ---------------------------------------------------------------------------

template <typename T>
struct LevelArgs {
  const int* __restrict__ level_ptr;  // nlev + 1 slot offsets
  const int* __restrict__ slot_row;   // the row of each slot
  const int* __restrict__ slot_ptr;   // nslots + 1 entry offsets
  const T* __restrict__ slot_diag;
  const int* __restrict__ ent_col;
  const T* __restrict__ ent_val;
  const T* __restrict__ b;
  T* __restrict__ x;
  int k;
};

// One (slot, column) item: what does not depend on x.
template <typename T>
struct LevelItem {
  int row, c, e0, e1;
  T diag, rhs;
  int col[KRYLOV_LEVEL_ENTRIES];
  T val[KRYLOV_LEVEL_ENTRIES];
};

template <typename T>
__device__ __forceinline__ void level_load(const LevelArgs<T>& a, long long item,
                                           LevelItem<T>& it) {
  const int slot = (int)(item / a.k);
  it.c = (int)(item % a.k);
  it.row = a.slot_row[slot];
  it.e0 = a.slot_ptr[slot];
  it.e1 = a.slot_ptr[slot + 1];
  it.diag = a.slot_diag[slot];
  it.rhs = a.b[(size_t)it.row * a.k + it.c];
#pragma unroll
  for (int q = 0; q < KRYLOV_LEVEL_ENTRIES; ++q) {
    if (it.e0 + q < it.e1) {
      it.col[q] = a.ent_col[it.e0 + q];
      it.val[q] = a.ent_val[it.e0 + q];
    }
  }
}

template <typename T>
__device__ __forceinline__ void level_finish(const LevelArgs<T>& a, const LevelItem<T>& it) {
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < KRYLOV_LEVEL_ENTRIES; ++q) {
    if (it.e0 + q < it.e1) acc = acc + it.val[q] * a.x[(size_t)it.col[q] * a.k + it.c];
  }
  for (int e = it.e0 + KRYLOV_LEVEL_ENTRIES; e < it.e1; ++e) {
    acc = acc + a.ent_val[e] * a.x[(size_t)a.ent_col[e] * a.k + it.c];
  }
  a.x[(size_t)it.row * a.k + it.c] = tri_div(it.rhs - acc, it.diag);
}

// Levels l0 .. l1 - 1, one CTA, a block barrier between levels.
template <typename T>
__global__ void __launch_bounds__(KRYLOV_LEVEL_THREADS)
level_run_kernel(LevelArgs<T> a, int l0, int l1) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int s0 = a.level_ptr[l0];
  int s1 = a.level_ptr[l0 + 1];
  LevelItem<T> cur;
  bool has = tid < (long long)(s1 - s0) * a.k;
  if (has) level_load(a, (long long)s0 * a.k + tid, cur);
  for (int l = l0; l < l1; ++l) {
    const bool more = l + 1 < l1;
    const int s2 = more ? a.level_ptr[l + 2] : s1;
    LevelItem<T> nxt;
    const bool has_next = more && tid < (long long)(s2 - s1) * a.k;
    if (has_next) level_load(a, (long long)s1 * a.k + tid, nxt);
    if (has) level_finish(a, cur);
    const long long items = (long long)(s1 - s0) * a.k;
    for (long long t = tid + nt; t < items; t += nt) {
      LevelItem<T> it;
      level_load(a, (long long)s0 * a.k + t, it);
      level_finish(a, it);
    }
    __syncthreads();
    cur = nxt;
    has = has_next;
    s0 = s1;
    s1 = s2;
  }
}

// The slots s0 .. s1 - 1 of one wide level, over many CTAs.
template <typename T>
__global__ void __launch_bounds__(KRYLOV_LEVEL_WIDE_THREADS)
level_wide_kernel(LevelArgs<T> a, int s0, int s1) {
  const long long items = (long long)(s1 - s0) * a.k;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < items; t += step) {
    LevelItem<T> it;
    level_load(a, (long long)s0 * a.k + t, it);
    level_finish(a, it);
  }
}

// sched: nlaunch rows of (kind, l0, l1, s0, s1); kind 0 a run of levels
// l0 .. l1 - 1, kind 1 the wide level of slots s0 .. s1 - 1.
template <typename T>
int launch_level_sweep(const LevelArgs<T>& a, const int* sched, int nlaunch, cudaStream_t s) {
  for (int q = 0; q < nlaunch; ++q) {
    const int* r = sched + 5 * q;
    if (r[0] == 0) {
      level_run_kernel<T><<<1, KRYLOV_LEVEL_THREADS, 0, s>>>(a, r[1], r[2]);
    } else {
      const long long items = (long long)(r[4] - r[3]) * a.k;
      long long blocks = (items + KRYLOV_LEVEL_WIDE_THREADS - 1) / KRYLOV_LEVEL_WIDE_THREADS;
      if (blocks > 132 * 16) blocks = 132 * 16;
      if (blocks < 1) blocks = 1;
      level_wide_kernel<T><<<(unsigned)blocks, KRYLOV_LEVEL_WIDE_THREADS, 0, s>>>(a, r[3], r[4]);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename T>
int level_sweep_as(const void* level_ptr, const void* slot_row, const void* slot_ptr,
                   const void* slot_diag, const void* ent_col, const void* ent_val,
                   const void* b, void* x, int k, const int* sched, int nlaunch,
                   cudaStream_t s) {
  LevelArgs<T> a;
  a.level_ptr = static_cast<const int*>(level_ptr);
  a.slot_row = static_cast<const int*>(slot_row);
  a.slot_ptr = static_cast<const int*>(slot_ptr);
  a.slot_diag = static_cast<const T*>(slot_diag);
  a.ent_col = static_cast<const int*>(ent_col);
  a.ent_val = static_cast<const T*>(ent_val);
  a.b = static_cast<const T*>(b);
  a.x = static_cast<T*>(x);
  a.k = k;
  return launch_level_sweep<T>(a, sched, nlaunch, s);
}

}  // namespace

extern "C" {

int krylov_level_threads() { return KRYLOV_LEVEL_THREADS; }

// S1.  tt: dtype code of every operand; coeffs (ndiag, M, ny), a and d
// (M, ny), b and x (nrhs, M, ny); nb row bands (plane, back, dc) of the
// solved side, h = the largest back (0 without row bands).
int krylov_grid_sweep(int tt, const void* coeffs, const void* a, const void* d, const void* b,
                      void* x, int nrhs, int M, int ny, int upper, int h, int nb,
                      const int* planes, const int* backs, const int* dcs, void* stream) {
  if (nrhs < 1 || M < 1 || ny < 1 || nb < 0 || nb > KRYLOV_SWEEP_MAX_BANDS || h < 0) {
    return (int)cudaErrorInvalidValue;
  }
  SweepBands bands;
  bands.nb = nb;
  for (int q = 0; q < nb; ++q) {
    if (backs[q] < 1 || backs[q] > h) return (int)cudaErrorInvalidValue;
    bands.plane[q] = planes[q];
    bands.back[q] = backs[q];
    bands.dc[q] = dcs[q];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tt) {
    case KRYLOV_F32: return launch_grid_sweep<float>(coeffs, a, d, b, x, nrhs, M, ny, upper, h, bands, s);
    case KRYLOV_F64: return launch_grid_sweep<double>(coeffs, a, d, b, x, nrhs, M, ny, upper, h, bands, s);
    case KRYLOV_C64: return launch_grid_sweep<c64>(coeffs, a, d, b, x, nrhs, M, ny, upper, h, bands, s);
    case KRYLOV_C128: return launch_grid_sweep<c128>(coeffs, a, d, b, x, nrhs, M, ny, upper, h, bands, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// S2.  tt: dtype code of slot_diag, ent_val, b and x; b and x (n, k).
int krylov_level_sweep(int tt, const void* level_ptr, const void* slot_row, const void* slot_ptr,
                       const void* slot_diag, const void* ent_col, const void* ent_val,
                       const void* b, void* x, int k, const int* sched, int nlaunch,
                       void* stream) {
  if (k < 1 || nlaunch < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tt) {
    case KRYLOV_F32: return level_sweep_as<float>(level_ptr, slot_row, slot_ptr, slot_diag, ent_col, ent_val, b, x, k, sched, nlaunch, s);
    case KRYLOV_F64: return level_sweep_as<double>(level_ptr, slot_row, slot_ptr, slot_diag, ent_col, ent_val, b, x, k, sched, nlaunch, s);
    case KRYLOV_C64: return level_sweep_as<c64>(level_ptr, slot_row, slot_ptr, slot_diag, ent_col, ent_val, b, x, k, sched, nlaunch, s);
    case KRYLOV_C128: return level_sweep_as<c128>(level_ptr, slot_row, slot_ptr, slot_diag, ent_col, ent_val, b, x, k, sched, nlaunch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
