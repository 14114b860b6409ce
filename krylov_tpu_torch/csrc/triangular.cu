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
// layout and the launch's shape, so a sweep repeats bit for bit.  The order
// differs from the plain versions' (a doubling scan across a grid row;
// products summed by segment_reduce), so results agree with them to
// rounding.
//
// ---------------------------------------------------------------------------
// S1: the grid sweep.  (D/omega + L) x = b on a grid stencil's lower
// triangle, or (D/omega + U) x = b on its upper one, for nrhs right-hand
// sides (M, ny) each.
//
// Bound on this card: the chain of M dependent grid rows, not the bytes
// (b, the coefficient planes and x once each: 5 planes for a 5-point
// stencil, ~100 us at 4096^2 f32 against milliseconds of chain).  A row is
// an affine recurrence x_j = a_j x_{j-1} + c_j across its columns, a scan of
// affine maps; the time a row takes is the latency of that scan.
//
// Design: a right-hand side is one thread-block cluster of C CTAs (the
// wrapper picks C by the row's width; up to 16, the non-portable size, where
// the occupancy API says it schedules).  CTA k owns the strip of w =
// ceil(ny / C) consecutive positions k w .. (k + 1) w - 1 in scan order
// (columns left to right for the lower triangle, right to left for the
// upper one, whose rows are walked from the last); it has nt worker
// threads and a publishing warp.  For each row:
//  1. the workers form c = (b - sum_q plane_q x[row - back_q, (j + dc_q) mod
//     ny]) / d and a for the strip (the reference's jnp.roll wrap-around;
//     rows before the first read as zero), the solved rows from the CTA's
//     ring of the last h + 1 strip rows in shared memory; a band with dc !=
//     0 reads the owner's ring through distributed shared memory.  A row's
//     b, d, a and first row bands do not depend on x: each worker copies
//     its positions' two rows ahead into shared memory (cp.async), so the
//     chain does not wait for device memory;
//  2. each warp scans its lanes' maps (shuffles); after a block barrier the
//     publishing warp scans the warps' totals and publishes the strip's map
//     (A_k, C_k), double-buffered by row parity;
//  3. one cluster barrier: the publishing warp's arrival releases the map,
//     the workers' are relaxed, so that no store in flight holds it (a
//     releasing arrival waits for the thread's loads and stores in flight;
//     tools/torch_sweeps.py --handoff);
//  4. the publishing warp reads the maps of the strips before its own
//     across the cluster, one a lane, scans them across lanes into the x
//     entering its strip, and gives each warp the x entering its positions;
//     after a block barrier each worker's x is one fused multiply-add;
//  5. the strip's row goes into the ring and to device memory.
// A 5-point stencil (every row band dc = 0) reads only values its own thread
// wrote, so it pays one cluster barrier a row; a band with dc != 0 adds a
// second after step 5; a cluster of one pays none.  Where a CTA's strip is
// wider than its workers, each owns a segment of consecutive positions
// whose c values wait in shared memory.  When h + 1 strip rows do not fit
// in KRYLOV_SWEEP_SMEM bytes (a very wide row), the solved rows are read
// from device memory and c waits in the output row.  The d == 0 guards and the zero a at the row's first
// position are in the planes `a` and `d` the wrapper prepares once.
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
// KRYLOV_LEVEL_ENTRIES of its entries do not depend on x, so a run loads
// them ahead of the chain: a thread's first item of level l + 2 its slot's
// head (row, entry range, diagonal), of level l + 1 its b and entries, while
// it finishes level l.
// A run may keep the solutions of its last W + 1 levels in a ring in
// shared memory: the host writes a second copy of the columns in which an
// entry whose column lies 1 to W levels back in its run holds its place in
// the window instead (negative), and the kernel reads x there instead of
// from device memory (for ILU(0) on a 5-point grid, W = 1: every entry).
// W is the run's farthest such reach, up to a cap, where W + 1 levels of
// its widest level at k right-hand sides fit in shared memory; any other
// run is the kernel without the window, which reads every x from device
// memory.  Each row sums its entries in their stored order.  (Streaming each level's
// structure ahead by bulk copies, with b gathered and x leaving by bulk
// copies, measured slower on this card: PERF.md section 6.)
// ---------------------------------------------------------------------------

#include "krylov_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

#define KRYLOV_SWEEP_MAX_BANDS 16
#define KRYLOV_SWEEP_MAX_CLUSTER 16
// shared memory for the ring of solved strip rows (and a segment's c values)
#ifndef KRYLOV_SWEEP_SMEM
#define KRYLOV_SWEEP_SMEM (200 * 1024)
#endif
// row bands whose coefficients are loaded a row ahead (a 9-point stencil's 3)
#define KRYLOV_SWEEP_PRE 3
#define KRYLOV_LEVEL_THREADS 1024
#define KRYLOV_LEVEL_WIDE_THREADS 256
#ifndef KRYLOV_LEVEL_ENTRIES
#define KRYLOV_LEVEL_ENTRIES 4
#endif
#define KRYLOV_LEVEL_SMEM (220 * 1024)

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

// The largest dynamic shared memory `kernel` may take, raised only when a
// launch needs more (the attribute is a ceiling; setting it is a runtime
// call that a launch need not pay again).  *have: what this kernel has now.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes, int* have) {
  if ((int)bytes <= *have) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *have = (int)bytes;
  return err;
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

// A strip row in shared memory, one padding element after every 32: a
// segment's consecutive positions (stride `seg` across a warp) fall on
// distinct banks.
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }
__host__ __device__ inline int padded_row(int w) { return w + (w >> 5) + 1; }

// The cluster barrier: every thread of every CTA of the cluster arrives,
// then waits (acquiring what the releasing arrivals wrote before).  An
// arrival that releases orders the thread's earlier accesses, shared and
// global, and so waits for its loads and stores in flight; a relaxed one
// orders nothing (tools/torch_sweeps.py --handoff).  A cluster of one is a
// block barrier.
__device__ __forceinline__ void cluster_barrier(int C, bool release = true) {
  if (C == 1) {
    __syncthreads();
    return;
  }
  if (release) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  } else {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T shfl_idx(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl_idx(cplx<R> v, int src) {
  return cplx<R>(__shfl_sync(0xffffffffu, v.re, src), __shfl_sync(0xffffffffu, v.im, src));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// one element of device memory into shared memory, asynchronously (the
// thread's later cp.async.wait_group makes it visible to the thread itself)
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(smem_addr(dst)), "l"((unsigned long long)src), "n"((int)sizeof(T))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` (0, 1 or 2) of this thread's newest groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// The inputs of a row that do not depend on x: b, d, a and the first
// KRYLOV_SWEEP_PRE row bands' coefficients.
#define KRYLOV_SWEEP_NQ (3 + KRYLOV_SWEEP_PRE)

// How a strip's next rows reach it (one position a worker): FETCH_REGS one row ahead into
// registers; FETCH_ASYNC two rows ahead by each worker's cp.async into a
// ring of 3 rows in shared memory (no load of device memory in flight at a
// barrier, which would wait for it: tools/torch_sweeps.py --handoff).
enum { FETCH_REGS = 0, FETCH_ASYNC = 1 };

// blockDim.x = nt + 32: nt workers, then the publishing warp.  !SEG: worker
// t owns position t of its CTA's strip; the ring and the stages hold strip
// rows of `rs` values in position order.  SEG: worker t owns the `seg`
// consecutive positions t * seg ..., the ring in position order with a
// padding element every 32.
template <typename T, bool SEG>
__global__ void __launch_bounds__(1024)
grid_strip_kernel(const T* __restrict__ coeffs, const T* __restrict__ a,
                  const T* __restrict__ d, const T* __restrict__ b, T* __restrict__ x, int M,
                  int ny, int upper, int h, int w, int seg, int in_smem, int fetch_mode,
                  int halo, SweepBands bands) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char sweep_smem[];
  __shared__ __align__(16) unsigned char maps[(3 * 32 + 4) * sizeof(T)];
  T* s_wa = reinterpret_cast<T*>(maps);  // the warps' maps
  T* s_wc = s_wa + 32;
  T* s_xin = s_wc + 32;  // the x entering each warp's positions
  T* s_ta = s_xin + 32;  // the strip's map, by row parity (read across the cluster)
  T* s_tc = s_ta + 2;
  const int hh = h + 1;
  const int rs = SEG ? padded_row(w) : w;
  const int tid = threadIdx.x;
  const int nt = blockDim.x - 32;  // workers
  const bool comm = tid >= nt;     // the publishing warp
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  T* ring = reinterpret_cast<T*>(sweep_smem);  // hh solved strip rows, slot s % hh
  T* cbuf = ring + (size_t)hh * rs;            // a segment's c values (SEG)
  T* stage = cbuf;                             // 3 rows of inputs, NQ planes a row (!SEG)
  const size_t plane_n = (size_t)M * ny;
  const size_t rhs = blockIdx.x / C;
  b += rhs * plane_n;
  x += rhs * plane_n;
  const int p0 = rank * w;                      // the strip's first position
  const int wn = max(min(p0 + w, ny) - p0, 0);  // its positions in this grid
  auto column = [&](int lp) { return upper ? ny - 1 - (p0 + lp) : p0 + lp; };
  // where strip position lp lies in a ring row
  auto rix = [&](int lp) { return SEG ? padded(lp) : lp; };
  // x[row - back_q, (j + dc_q) mod ny] of band q, for the position lp of
  // column j in row s (i the grid row), s >= back_q
  auto solved = [&](int q, int s, int i, int j, int lp) -> T {
    const int back = bands.back[q];
    int jj = j + bands.dc[q];  // |dc| < ny: one wrap at most
    jj = jj < 0 ? jj + ny : (jj >= ny ? jj - ny : jj);
    if (!in_smem) return x[(size_t)(upper ? i + back : i - back) * ny + jj];
    int from = s % hh - back;
    from = from < 0 ? from + hh : from;
    if (bands.dc[q] == 0) return ring[(size_t)from * rs + rix(lp)];
    const int pp = upper ? ny - 1 - jj : jj;
    const int owner = pp / w;
    const T* rr = owner == rank ? ring : cluster.map_shared_rank(ring, owner);
    return rr[(size_t)from * rs + rix(pp - owner * w)];
  };
  // the publishing warp, a row's maps: the warps' maps scanned (lane e
  // keeps the exclusive prefix of map e in pa, pc), the strip's map
  // published; then, once every strip's is, the x entering each warp: lane
  // r holds strip r's map, the strips before this one scanned across lanes
  T pa = T(1), pc = T(0);
  auto block_maps = [&](int par) {
    T wa = lane < nwarps ? s_wa[lane] : T(1);
    T wc = lane < nwarps ? s_wc[lane] : T(0);
    for (int o = 1; o < nwarps; o <<= 1) {
      const T qa = shfl_up(wa, o);
      const T qc = shfl_up(wc, o);
      if (lane >= o) {
        wc = wa * qc + wc;
        wa = wa * qa;
      }
    }
    pa = shfl_up(wa, 1);
    pc = shfl_up(wc, 1);
    if (lane == 0) {
      pa = T(1);
      pc = T(0);
    }
    if (lane == nwarps - 1) {
      s_ta[par] = wa;
      s_tc[par] = wc;
    }
  };
  auto entries = [&](int par) {
    T X = T(0);
    if (rank > 0) {
      T ra = T(1), rc = T(0);
      if (lane < rank) {
        ra = *cluster.map_shared_rank(&s_ta[par], lane);
        rc = *cluster.map_shared_rank(&s_tc[par], lane);
      }
#pragma unroll
      for (int o = 1; o < KRYLOV_SWEEP_MAX_CLUSTER; o <<= 1) {
        const T qa = shfl_up(ra, o);
        const T qc = shfl_up(rc, o);
        if (lane >= o) {
          rc = ra * qc + rc;
          ra = ra * qa;
        }
      }
      X = shfl_idx(rc, rank - 1);
    }
    if (lane < nwarps) s_xin[lane] = pa * X + pc;
  };

  if constexpr (!SEG) {
    const int nq = 3 + min(bands.nb, KRYLOV_SWEEP_PRE);  // planes a row's inputs take
    const int lp = tid;                                  // this worker's position
    cluster_barrier(C);  // every CTA of the cluster runs before any reads another's shared memory
    // the planes of a row's inputs: b, d, a and the first row bands' coefficients
    auto plane = [&](int q) -> const T* {
      return q == 0 ? b : q == 1 ? d : q == 2 ? a : coeffs + bands.plane[q - 3] * plane_n;
    };
    T nb_v[KRYLOV_SWEEP_NQ];
    // this worker's position of grid row ii: into the stage slot (async) or registers
    auto fetch = [&](int ii, int slot) {
      if (lp < wn) {
        const size_t at = (size_t)ii * ny + column(lp);
#pragma unroll
        for (int q = 0; q < KRYLOV_SWEEP_NQ; ++q) {
          if (q < nq) {
            if (fetch_mode == FETCH_ASYNC) {
              cp_async_elem(stage + (size_t)(slot * KRYLOV_SWEEP_NQ + q) * rs + lp,
                            plane(q) + at);
            } else {
              nb_v[q] = plane(q)[at];
            }
          }
        }
      }
    };
    if (!comm) {
      fetch(upper ? M - 1 : 0, 0);
      if (fetch_mode == FETCH_ASYNC) {
        cp_async_commit();
        if (M > 1) fetch(upper ? M - 2 : 1, 1);
        cp_async_commit();
      }
    }
    for (int s = 0; s < M; ++s) {
      const int i = upper ? M - 1 - s : s;
      const size_t row = (size_t)i * ny;
      const int par = s & 1;
      T A = T(1), Cc = T(0);
      if (!comm) {
        // 1. c and a of this worker's position
        if (fetch_mode == FETCH_ASYNC) {
          cp_async_wait(1);  // row s's inputs have landed (row s + 1's may not)
#pragma unroll
          for (int q = 0; q < KRYLOV_SWEEP_NQ; ++q) {
            if (q < nq && lp < wn) {
              nb_v[q] = stage[(size_t)((s % 3) * KRYLOV_SWEEP_NQ + q) * rs + lp];
            }
          }
        }
        if (lp < wn) {
          const int j = column(lp);
          T r = nb_v[0];
#pragma unroll
          for (int q = 0; q < KRYLOV_SWEEP_PRE; ++q) {
            if (q < bands.nb && s >= bands.back[q]) r = r - nb_v[3 + q] * solved(q, s, i, j, lp);
          }
          for (int q = KRYLOV_SWEEP_PRE; q < bands.nb; ++q) {
            if (s >= bands.back[q]) {
              r = r - coeffs[bands.plane[q] * plane_n + row + j] * solved(q, s, i, j, lp);
            }
          }
          Cc = tri_div(r, nb_v[1]);
          A = nb_v[2];
        }
        if (fetch_mode == FETCH_ASYNC) {
          if (s + 2 < M) fetch(upper ? i - 2 : i + 2, (s + 2) % 3);
          cp_async_commit();
        } else if (fetch_mode == FETCH_REGS && s + 1 < M) {
          fetch(upper ? i - 1 : i + 1, 0);
        }
        // 2. the lanes scanned, the warps' totals to the publishing warp
        warp_scan_maps(A, Cc, lane);
        if (lane == 31) {
          s_wa[warp] = A;
          s_wc[warp] = Cc;
        }
      }
      __syncthreads();
      // 3. the strips' maps published across the cluster: the publishing
      // warp's arrival releases them, the workers' are relaxed (their
      // copies and stores in flight need not land first)
      if (comm) block_maps(par);
      if (C > 1) cluster_barrier(C, comm);
      // 4. the x entering each warp, then the position's x
      if (comm) entries(par);
      __syncthreads();
      if (!comm) {
        const T xv = A * s_xin[warp] + Cc;
        // 5. into the ring and to device memory
        if (lp < wn) {
          if (in_smem) ring[(size_t)(s % hh) * rs + lp] = xv;
          x[row + column(lp)] = xv;
        }
      }
      if (halo) {  // the neighbours read this row's halo from the ring (or x)
        if (!in_smem) __threadfence();
        cluster_barrier(C);
      }
    }
    if (fetch_mode == FETCH_ASYNC && !comm) cp_async_wait(0);
  } else {
    cluster_barrier(C);  // every CTA of the cluster runs before any reads another's shared memory
    const int q0 = min(tid * seg, wn);
    const int q1 = comm ? q0 : min(q0 + seg, wn);
    for (int s = 0; s < M; ++s) {
      const int i = upper ? M - 1 - s : s;
      const size_t row = (size_t)i * ny;
      const int par = s & 1;
      T A = T(1), Cc = T(0);
      if (!comm) {
        // 1. c of this worker's segment (into cbuf, or the output row), its map
        for (int lp = q0; lp < q1; ++lp) {
          const int j = column(lp);
          T r = b[row + j];
          for (int q = 0; q < bands.nb; ++q) {
            if (s >= bands.back[q]) {
              r = r - coeffs[bands.plane[q] * plane_n + row + j] * solved(q, s, i, j, lp);
            }
          }
          const T c = tri_div(r, d[row + j]);
          const T aj = a[row + j];
          if (in_smem) {
            cbuf[padded(lp)] = c;
          } else {
            x[row + j] = c;
          }
          A = aj * A;
          Cc = aj * Cc + c;
        }
        // 2.
        warp_scan_maps(A, Cc, lane);
        if (lane == 31) {
          s_wa[warp] = A;
          s_wc[warp] = Cc;
        }
      }
      __syncthreads();
      // 3.
      if (comm) block_maps(par);
      if (C > 1) cluster_barrier(C, comm);
      // 4. x entering this worker's segment, then its recurrence
      if (comm) entries(par);
      __syncthreads();
      if (!comm) {
        const T xw = s_xin[warp];
        const T pa = shfl_up(A, 1);
        const T pc = shfl_up(Cc, 1);
        T xv = lane > 0 ? pa * xw + pc : xw;
        for (int lp = q0; lp < q1; ++lp) {
          const int j = column(lp);
          xv = a[row + j] * xv + (in_smem ? cbuf[padded(lp)] : x[row + j]);
          // 5.
          if (in_smem) ring[(size_t)(s % hh) * rs + padded(lp)] = xv;
          x[row + j] = xv;
        }
      }
      if (halo) {
        if (!in_smem) __threadfence();
        cluster_barrier(C);
      }
    }
  }
  cluster_barrier(C);  // no CTA leaves while another may still read its shared memory
}

template <typename T>
struct StripCall {
  const T* coeffs;
  const T* a;
  const T* d;
  const T* b;
  T* x;
  int M, ny, upper, h, halo;
  SweepBands bands;
};

// Launch (or, with `active`, ask the occupancy API about) the cluster
// launch of one strip kernel: nrhs clusters of C CTAs of nt workers and the
// publishing warp.  info (when given): positions a worker (1, or 0 for a
// segment of seg), seg, in_smem, dynamic shared memory bytes, the fetch mode.
template <typename T, bool SEG>
int strip_launch(const StripCall<T>& g, int nrhs, int C, int nt, int w, int seg, int* active,
                 int* info, cudaStream_t s) {
  const int rs = SEG ? padded_row(w) : w;
  const size_t ring = (size_t)(g.h + 1) * rs * sizeof(T);
  const size_t extra = SEG ? (size_t)rs * sizeof(T) : (size_t)3 * KRYLOV_SWEEP_NQ * rs * sizeof(T);
  const int in_smem = ring + (SEG ? extra : 0) <= KRYLOV_SWEEP_SMEM;
  const int fetch_mode =
      SEG || !in_smem || ring + extra > KRYLOV_SWEEP_SMEM ? FETCH_REGS : FETCH_ASYNC;
  const int smem = in_smem ? (int)(ring + (SEG || fetch_mode != FETCH_REGS ? extra : 0)) : 0;
  if (info) {
    info[0] = SEG ? 0 : 1;
    info[1] = seg;
    info[2] = in_smem;
    info[3] = smem;
    info[4] = fetch_mode;
  }
  const auto kernel = grid_strip_kernel<T, SEG>;
  static int have_smem = 0;
  static bool nonportable = false;
  cudaError_t err = allow_smem(kernel, (size_t)smem, &have_smem);
  if (err != cudaSuccess) return (int)err;
  if (C > 8 && !nonportable) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    nonportable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nrhs * C), 1, 1);
  cfg.blockDim = dim3((unsigned)(nt + 32), 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active) return (int)cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, g.coeffs, g.a, g.d, g.b, g.x, g.M, g.ny, g.upper, g.h, w,
                           seg, in_smem, fetch_mode, g.halo, g.bands);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grid_sweep(const void* coeffs, const void* a, const void* d, const void* b, void* x,
                      int nrhs, int M, int ny, int upper, int h, const SweepBands& bands, int C,
                      int nt, int* active, int* info, cudaStream_t s) {
  StripCall<T> g{static_cast<const T*>(coeffs), static_cast<const T*>(a),
                 static_cast<const T*>(d), static_cast<const T*>(b), static_cast<T*>(x),
                 M, ny, upper, h, 0, bands};
  for (int q = 0; q < bands.nb; ++q) g.halo |= bands.dc[q] != 0;
  const int w = (ny + C - 1) / C;
  const int need = (w + nt - 1) / nt;  // positions a worker
  if (need <= 1) return strip_launch<T, false>(g, nrhs, C, nt, w, 1, active, info, s);
  return strip_launch<T, true>(g, nrhs, C, nt, w, need, active, info, s);
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
  const int* __restrict__ ent_col;    // each entry's column
  const int* __restrict__ ent_win;    // or, where a run's window holds it, -1 - (back << 16 | place)
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

// A slot's head: what its item's other loads need first.
template <typename T>
struct LevelHead {
  int row, e0, e1;
  T diag;
};

template <typename T>
__device__ __forceinline__ void level_head(const LevelArgs<T>& a, int slot, LevelHead<T>& h) {
  h.row = a.slot_row[slot];
  h.e0 = a.slot_ptr[slot];
  h.e1 = a.slot_ptr[slot + 1];
  h.diag = a.slot_diag[slot];
}

// the item of a slot whose head is h, column c: its b and first entries,
// their columns from `cols`
template <typename T>
__device__ __forceinline__ void level_body(const LevelArgs<T>& a, const int* cols,
                                           const LevelHead<T>& h, int c, LevelItem<T>& it) {
  it.c = c;
  it.row = h.row;
  it.e0 = h.e0;
  it.e1 = h.e1;
  it.diag = h.diag;
  it.rhs = a.b[(size_t)it.row * a.k + it.c];
#pragma unroll
  for (int q = 0; q < KRYLOV_LEVEL_ENTRIES; ++q) {
    if (it.e0 + q < it.e1) {
      it.col[q] = cols[it.e0 + q];
      it.val[q] = a.ent_val[it.e0 + q];
    }
  }
}

template <typename T>
__device__ __forceinline__ void level_load(const LevelArgs<T>& a, const int* cols, int slot,
                                           int c, LevelItem<T>& it) {
  LevelHead<T> h;
  level_head(a, slot, h);
  level_body(a, cols, h, c, it);
}

// x of an entry: a column, or (WIN) a place in the window (the last W + 1
// levels, R rows x k each, in turn: this level at ring slot ls, the level
// `back` before at ls - back mod W + 1)
template <typename T, bool WIN>
__device__ __forceinline__ T level_x(const LevelArgs<T>& a, int col, int c, int ls, int W, int R,
                                     const T* ring) {
  if constexpr (WIN) {
    if (col < 0) {
      const int p = -1 - col;
      int from = ls - (p >> 16);
      from = from < 0 ? from + W + 1 : from;
      return ring[((size_t)from * R + (p & 0xffff)) * a.k + c];
    }
  }
  return a.x[(size_t)col * a.k + c];
}

// the item's x to device memory and (WIN) to its place in the window: t,
// the item's number within its level (its slot's place x k + column)
template <typename T, bool WIN>
__device__ __forceinline__ void level_finish(const LevelArgs<T>& a, const int* cols,
                                             const LevelItem<T>& it, int t, int ls, int W,
                                             int R, T* ring) {
  T acc = T(0);
#pragma unroll
  for (int q = 0; q < KRYLOV_LEVEL_ENTRIES; ++q) {
    if (it.e0 + q < it.e1) {
      acc = acc + it.val[q] * level_x<T, WIN>(a, it.col[q], it.c, ls, W, R, ring);
    }
  }
  for (int e = it.e0 + KRYLOV_LEVEL_ENTRIES; e < it.e1; ++e) {
    acc = acc + a.ent_val[e] * level_x<T, WIN>(a, cols[e], it.c, ls, W, R, ring);
  }
  const T xr = tri_div(it.rhs - acc, it.diag);
  a.x[(size_t)it.row * a.k + it.c] = xr;
  if constexpr (WIN) ring[(size_t)ls * R * a.k + t] = xr;
}

// Levels l0 .. l1 - 1, one CTA, a block barrier between levels.  A level's
// items are slot x k + column in turn, thread tid's first the item tid (slot
// tid / k, column tid % k, divided once).  That first item is loaded in a
// pipeline, so that no load waits on the chain: while level l is finished,
// level l + 1's b and entries are loaded from its slot's head, read while
// level l - 1 was, and level l + 2's head, from the slot offsets read a
// level before.  WIN: a window of the last W + 1 levels' x (R rows x k
// each) in dynamic shared memory, the columns from ent_win; else every x
// from device memory.
template <typename T, bool WIN>
__global__ void __launch_bounds__(KRYLOV_LEVEL_THREADS)
level_run_kernel(LevelArgs<T> a, int l0, int l1, int W, int R) {
  extern __shared__ __align__(16) unsigned char level_smem[];
  T* ring = reinterpret_cast<T*>(level_smem);
  const int* cols = WIN ? a.ent_win : a.ent_col;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int tq = tid / a.k, tr = tid % a.k;
  // levels l .. l + 3 start at slots s0 .. s3 (a level past the run is empty)
  int s0 = a.level_ptr[l0];
  int s1 = a.level_ptr[l0 + 1];
  int s2 = l0 + 1 < l1 ? a.level_ptr[l0 + 2] : s1;
  int s3 = l0 + 2 < l1 ? a.level_ptr[l0 + 3] : s2;
  LevelItem<T> cur;  // level l's
  bool has = tq < s1 - s0;
  if (has) level_load(a, cols, s0 + tq, tr, cur);
  LevelHead<T> head;  // level l + 1's
  bool has_head = tq < s2 - s1;
  if (has_head) level_head(a, s1 + tq, head);
  int ls = 0;  // this level's ring slot (WIN): levels take slots in turn
  for (int l = l0; l < l1; ++l) {
    const int s4 = l + 3 < l1 ? a.level_ptr[l + 4] : s3;
    LevelHead<T> head2;  // level l + 2's
    const bool has_head2 = tq < s3 - s2;
    if (has_head2) level_head(a, s2 + tq, head2);
    LevelItem<T> nxt;
    if (has_head) level_body(a, cols, head, tr, nxt);
    if (has) level_finish<T, WIN>(a, cols, cur, tid, ls, W, R, ring);
    const int items = (s1 - s0) * a.k;
    for (int t = tid + nt; t < items; t += nt) {
      LevelItem<T> it;
      level_load(a, cols, s0 + t / a.k, t % a.k, it);
      level_finish<T, WIN>(a, cols, it, t, ls, W, R, ring);
    }
    __syncthreads();
    if constexpr (WIN) ls = ls == W ? 0 : ls + 1;
    cur = nxt;
    has = has_head;
    head = head2;
    has_head = has_head2;
    s0 = s1;
    s1 = s2;
    s2 = s3;
    s3 = s4;
  }
}

// The slots s0 .. s1 - 1 of one wide level, over many CTAs (no window).
template <typename T>
__global__ void __launch_bounds__(KRYLOV_LEVEL_WIDE_THREADS)
level_wide_kernel(LevelArgs<T> a, int s0, int s1) {
  const long long items = (long long)(s1 - s0) * a.k;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < items; t += step) {
    LevelItem<T> it;
    level_load(a, a.ent_col, s0 + (int)(t / a.k), (int)(t % a.k), it);
    level_finish<T, false>(a, a.ent_col, it, 0, 0, 0, 1, static_cast<T*>(nullptr));
  }
}

// sched: nlaunch rows of KRYLOV_LEVEL_ROW ints: (kind, l0, l1, s0, s1, W,
// R); kind 0 a run of levels l0 .. l1 - 1 with a window of W levels of R
// rows, kind 1 the wide level of slots s0 .. s1 - 1.
#define KRYLOV_LEVEL_ROW 7

template <typename T>
int launch_level_sweep(const LevelArgs<T>& a, const int* sched, int nlaunch, cudaStream_t s) {
  for (int q = 0; q < nlaunch; ++q) {
    const int* r = sched + KRYLOV_LEVEL_ROW * q;
    if (r[0] == 0) {
      const int W = r[5], R = r[6];
      if (R < 1 || (long long)R * a.k > 0x7fffffff) return (int)cudaErrorInvalidValue;
      if (W == 0) {
        level_run_kernel<T, false><<<1, KRYLOV_LEVEL_THREADS, 0, s>>>(a, r[1], r[2], 0, 1);
      } else {
        const size_t smem = (size_t)(W + 1) * R * a.k * sizeof(T);
        if (smem > KRYLOV_LEVEL_SMEM || W < 0 || W > 0xffff || R > 0x10000) {
          return (int)cudaErrorInvalidValue;
        }
        static int have_smem = 0;
        const cudaError_t err = allow_smem(level_run_kernel<T, true>, smem, &have_smem);
        if (err != cudaSuccess) return (int)err;
        level_run_kernel<T, true><<<1, KRYLOV_LEVEL_THREADS, smem, s>>>(a, r[1], r[2], W, R);
      }
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
int level_sweep_as(const void* const* p, const void* b, void* x, int k, const int* sched,
                   int nlaunch, cudaStream_t s) {
  LevelArgs<T> a;
  a.level_ptr = static_cast<const int*>(p[0]);
  a.slot_row = static_cast<const int*>(p[1]);
  a.slot_ptr = static_cast<const int*>(p[2]);
  a.slot_diag = static_cast<const T*>(p[3]);
  a.ent_col = static_cast<const int*>(p[4]);
  a.ent_win = static_cast<const int*>(p[5]);
  a.ent_val = static_cast<const T*>(p[6]);
  a.b = static_cast<const T*>(b);
  a.x = static_cast<T*>(x);
  a.k = k;
  return launch_level_sweep<T>(a, sched, nlaunch, s);
}

}  // namespace

extern "C" {

int krylov_level_threads() { return KRYLOV_LEVEL_THREADS; }
int krylov_level_smem() { return KRYLOV_LEVEL_SMEM; }

// S1.  tt: dtype code of every operand; coeffs (ndiag, M, ny), a and d
// (M, ny), b and x (nrhs, M, ny); nb row bands (plane, back, dc) of the
// solved side, h = the largest back (0 without row bands); a cluster of C
// CTAs of nt workers (and a publishing warp) a right-hand side.  With
// `active` nothing launches: *active is the number of such clusters the
// card can hold at once (0: it cannot schedule one), and info (5 ints) the
// kernel's positions a worker (1, or 0: a segment), seg, in_smem, shared
// memory and fetch mode (0 registers, 1 cp.async).
int krylov_grid_sweep(int tt, const void* coeffs, const void* a, const void* d, const void* b,
                      void* x, int nrhs, int M, int ny, int upper, int h, int nb,
                      const int* planes, const int* backs, const int* dcs, int C, int nt,
                      int* active, int* info, void* stream) {
  if (nrhs < 1 || M < 1 || ny < 1 || nb < 0 || nb > KRYLOV_SWEEP_MAX_BANDS || h < 0 || C < 1 ||
      C > KRYLOV_SWEEP_MAX_CLUSTER || nt < 32 || nt > 992 || nt % 32 != 0) {
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
    case KRYLOV_F32: return launch_grid_sweep<float>(coeffs, a, d, b, x, nrhs, M, ny, upper, h, bands, C, nt, active, info, s);
    case KRYLOV_F64: return launch_grid_sweep<double>(coeffs, a, d, b, x, nrhs, M, ny, upper, h, bands, C, nt, active, info, s);
    case KRYLOV_C64: return launch_grid_sweep<c64>(coeffs, a, d, b, x, nrhs, M, ny, upper, h, bands, C, nt, active, info, s);
    case KRYLOV_C128: return launch_grid_sweep<c128>(coeffs, a, d, b, x, nrhs, M, ny, upper, h, bands, C, nt, active, info, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// S2.  tt: dtype code of slot_diag, ent_val, b and x; b and x (n, k); p:
// level_ptr, slot_row, slot_ptr, slot_diag, ent_col, ent_win, ent_val;
// sched: nlaunch rows of KRYLOV_LEVEL_ROW ints.
int krylov_level_sweep(int tt, const void* const* p, const void* b, void* x, int k,
                       const int* sched, int nlaunch, void* stream) {
  if (k < 1 || nlaunch < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tt) {
    case KRYLOV_F32: return level_sweep_as<float>(p, b, x, k, sched, nlaunch, s);
    case KRYLOV_F64: return level_sweep_as<double>(p, b, x, k, sched, nlaunch, s);
    case KRYLOV_C64: return level_sweep_as<c64>(p, b, x, k, sched, nlaunch, s);
    case KRYLOV_C128: return level_sweep_as<c128>(p, b, x, k, sched, nlaunch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
