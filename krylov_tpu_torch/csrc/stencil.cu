// Hand-written Hopper (sm_90a) kernels for the grid-stencil solvers.
//
// Plain C interface, loaded with ctypes (krylov_tpu_torch/ops/cuda_stencil.py).
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so that a refused launch is reported at once.
//
// Layout contract (shared with the reference package): the grid is
// collapsed to 2-D (M, ny), row-major; each band d is a (dr[d], dc[d])
// pair and the operator computes
//
//     y[i, j] = sum_d c[d, i, j] * x[i + dr[d], j + dc[d]]
//
// Neighbours outside the grid read as zero: rows i + dr outside [0, M) come
// from the caller's top/bottom halo rows when given (zeros otherwise), and
// columns j + dc outside [0, ny) are zero.  Variable-coefficient kernels
// (K1, K5, K9) carry Dirichlet masking in the coefficient data: the
// constructors zero every coefficient whose neighbour leaves the grid.
// Constant-coefficient kernels (K2, K3, K8) carry scalar weights and mask
// in the kernel (ConstBands below).

#include "krylov_common.cuh"

#define KRYLOV_MAX_BANDS 32
#define KRYLOV_MAX_CONSTRAINTS 4  // row constraints per const band (5-D grids)
#define KRYLOV_THREADS 256  // threads per block, laid along ny
#define KRYLOV_ROWS 8       // grid rows each block walks in its row loop
#define KRYLOV_MAX_GRID_Y 65535
#define KRYLOV_PHASE_B_BLOCKS 2112  // 16 blocks per SM of the H100's 132

struct Bands {
  int n;
  int dr[KRYLOV_MAX_BANDS];
  int dc[KRYLOV_MAX_BANDS];
};

static bool make_bands(int ndiag, const int* dr, const int* dc, Bands* b) {
  if (ndiag < 1 || ndiag > KRYLOV_MAX_BANDS) return false;
  b->n = ndiag;
  for (int d = 0; d < ndiag; ++d) {
    b->dr[d] = dr[d];
    b->dc[d] = dc[d];
  }
  return true;
}

// Constant-coefficient bands: a scalar weight per band, and per band up to
// KRYLOV_MAX_CONSTRAINTS row constraints (stride, size, step).  Band d is
// valid on global row g iff 0 <= (g / stride) % size + step < size for each
// of its constraints (the n-D coordinate along each collapsed axis stays in
// the grid), and at column j iff 0 <= j + dc < ny.  Weights are stored in
// the real type of the accumulation (float for f32, bf16 and complex64
// vectors, double for f64 and complex128), rounded from the host's doubles
// as the reference's weak-typed Python floats round.
template <typename W>
struct ConstBands {
  int n;
  int hr, hc;    // max |dr|, max |dc|
  int any_cons;  // whether any band has a row constraint
  int dr[KRYLOV_MAX_BANDS];
  int dc[KRYLOV_MAX_BANDS];
  int ncons[KRYLOV_MAX_BANDS];
  int cons[KRYLOV_MAX_BANDS][KRYLOV_MAX_CONSTRAINTS][3];
  W w[KRYLOV_MAX_BANDS];
};

// cons holds KRYLOV_MAX_CONSTRAINTS (stride, size, step) triples per band.
template <typename W>
static bool make_const_bands(int ndiag, const int* dr, const int* dc,
                             const double* w, const int* ncons,
                             const int* cons, ConstBands<W>* b) {
  if (ndiag < 1 || ndiag > KRYLOV_MAX_BANDS) return false;
  b->n = ndiag;
  b->hr = b->hc = b->any_cons = 0;
  for (int d = 0; d < ndiag; ++d) {
    if (ncons[d] < 0 || ncons[d] > KRYLOV_MAX_CONSTRAINTS) return false;
    b->hr = dr[d] > b->hr ? dr[d] : (-dr[d] > b->hr ? -dr[d] : b->hr);
    b->hc = dc[d] > b->hc ? dc[d] : (-dc[d] > b->hc ? -dc[d] : b->hc);
    b->any_cons |= ncons[d] > 0;
    b->dr[d] = dr[d];
    b->dc[d] = dc[d];
    b->w[d] = static_cast<W>(w[d]);
    b->ncons[d] = ncons[d];
    for (int k = 0; k < KRYLOV_MAX_CONSTRAINTS; ++k) {
      for (int t = 0; t < 3; ++t) {
        b->cons[d][k][t] = cons[(d * KRYLOV_MAX_CONSTRAINTS + k) * 3 + t];
      }
      if (k < ncons[d] && (b->cons[d][k][0] < 1 || b->cons[d][k][1] < 1)) {
        return false;
      }
    }
  }
  return true;
}

static dim3 grid_2d(int M, int ny, int batch) {
  const int gx = (ny + KRYLOV_THREADS - 1) / KRYLOV_THREADS;
  int gy = (M + KRYLOV_ROWS - 1) / KRYLOV_ROWS;
  if (gy > KRYLOV_MAX_GRID_Y) gy = KRYLOV_MAX_GRID_Y;
  return dim3(gx, gy, batch);
}

// Bit d set iff band d's row constraints hold on global row g: evaluated
// once per row, not once per element.
template <typename W>
__device__ __forceinline__ unsigned const_row_mask(const ConstBands<W>& b, int g) {
  unsigned ok = 0u;
  for (int d = 0; d < b.n; ++d) {
    bool v = true;
    for (int k = 0; k < b.ncons[d]; ++k) {
      const int size = b.cons[d][k][1];
      const int s = (g / b.cons[d][k][0]) % size + b.cons[d][k][2];
      v = v && s >= 0 && s < size;
    }
    if (v) ok |= 1u << d;
  }
  return ok;
}

// The const stencil on the KRYLOV_ROWS rows i0.. of column j:
// acc[r] = sum over the bands valid at (i0 + r, j) of w[d] * src(neighbour),
// bands in the order given (the wrappers sort them by (dr, dc)); masked
// terms are skipped, where the reference selects 0 for them.  The weights
// are real (W); the accumulator A is W, or the complex type over it.
// src.at(q) reads the operand at flat index q inside the grid;
// src.outside(ii, jj) reads a row ii outside [0, M) (a halo row, or 0).
// Blocks whose neighbours all lie inside the grid take a fast path: the
// band loop outside, the rows unrolled inside, so the per-band set-up is
// paid once per KRYLOV_ROWS points and KRYLOV_ROWS loads are in flight
// (measured on the H100 at 4096^2, f32, 5 bands: 59 us against 102 us for a
// band loop per point and 54 us for a hard-coded 5-point kernel).  CONS: the
// bands carry row constraints, evaluated once per row.
template <bool CONS, typename W, typename A, typename Src>
__device__ __forceinline__ void const_rows(const ConstBands<W>& b, const Src& src,
                                           int i0, int j, int M, int ny,
                                           int row0, A (&acc)[KRYLOV_ROWS]) {
#pragma unroll
  for (int r = 0; r < KRYLOV_ROWS; ++r) acc[r] = A(0);
  if (i0 - b.hr >= 0 && i0 + KRYLOV_ROWS + b.hr <= M && j - b.hc >= 0 &&
      j + b.hc < ny) {
    unsigned ok[KRYLOV_ROWS];
#pragma unroll
    for (int r = 0; r < KRYLOV_ROWS; ++r) ok[r] = CONS ? const_row_mask(b, row0 + i0 + r) : ~0u;
    const long long q0 = (long long)i0 * ny + j;
    for (int d = 0; d < b.n; ++d) {
      const W w = b.w[d];
      const long long qd = q0 + (long long)b.dr[d] * ny + b.dc[d];
#pragma unroll
      for (int r = 0; r < KRYLOV_ROWS; ++r) {
        if (!CONS || ((ok[r] >> d) & 1u)) acc[r] += w * src.at(qd + (long long)r * ny);
      }
    }
    return;
  }
  for (int r = 0; r < KRYLOV_ROWS && i0 + r < M; ++r) {
    const int i = i0 + r;
    const unsigned ok = CONS ? const_row_mask(b, row0 + i) : ~0u;
    for (int d = 0; d < b.n; ++d) {
      const int ii = i + b.dr[d];
      const int jj = j + b.dc[d];
      if (((ok >> d) & 1u) && jj >= 0 && jj < ny) {
        acc[r] += b.w[d] * ((ii >= 0 && ii < M) ? src.at((long long)ii * ny + jj)
                                                : src.outside(ii, jj));
      }
    }
  }
}

// Operand readers for const_rows.
template <typename TX, typename A>
struct HaloSrc {  // x, with the caller's halo rows (or zeros) outside the grid
  const TX* __restrict__ x;
  const TX* __restrict__ top;
  const TX* __restrict__ bot;
  int M, ny, h;
  __device__ __forceinline__ A at(long long q) const { return to_acc<A>(x[q]); }
  __device__ __forceinline__ A outside(int ii, int jj) const {
    if (ii < 0 && top != nullptr) return to_acc<A>(top[(size_t)(h + ii) * ny + jj]);
    if (ii >= M && bot != nullptr) return to_acc<A>(bot[(size_t)(ii - M) * ny + jj]);
    return A(0);
  }
};

template <typename T>
struct ZeroSrc {  // z, zero outside the grid
  const T* __restrict__ z;
  __device__ __forceinline__ T at(long long q) const { return z[q]; }
  __device__ __forceinline__ T outside(int, int) const { return T(0); }
};

struct PUpdateSrc {  // r + omega * p, zero outside the grid
  const float* __restrict__ r;
  const float* __restrict__ p;
  float om;
  __device__ __forceinline__ float at(long long q) const { return r[q] + om * p[q]; }
  __device__ __forceinline__ float outside(int, int) const { return 0.0f; }
};

// ---------------------------------------------------------------------------
// K1: variable-coefficient stencil matvec.
//
// Replaces krylov_tpu/ops/pallas_stencil.py:stencil2d_matvec (_kernel,
// _band_accumulate).  Bound on this card: memory traffic, (ndiag + 2) * N
// words (every coefficient plane, x and y once) against ~2 flops per
// coefficient.  Design: one thread per output column, neighbouring threads
// on neighbouring addresses, so every coefficient and x read is coalesced;
// each block walks KRYLOV_ROWS rows, so the rows x[i + dr] it reads again
// are in L1/L2 and device memory sees x about once.  Neighbour rows are read
// straight from x (the TPU's pre-gathered halo planes are a Mosaic
// workaround), so y must not alias x: block i+1 reads rows of block i.
// Accumulates in A (float for f32/bf16, double for f64, the complex type
// for complex vectors, as the reference's XLA form does), stores TY.
// ---------------------------------------------------------------------------
template <typename TC, typename TX, typename TY, typename A>
__global__ void __launch_bounds__(KRYLOV_THREADS)
stencil2d_kernel(const TC* __restrict__ c, const TX* __restrict__ x,
                 const TX* __restrict__ top, const TX* __restrict__ bot,
                 TY* __restrict__ y, int M, int ny, int h, Bands bands) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ny) return;
  const size_t plane = (size_t)M * ny;
  const TX* xb = x + (size_t)blockIdx.z * plane;
  TY* yb = y + (size_t)blockIdx.z * plane;
  const int nrb = (M + KRYLOV_ROWS - 1) / KRYLOV_ROWS;
  for (int rb = blockIdx.y; rb < nrb; rb += gridDim.y) {
    const int i_end = min(M, (rb + 1) * KRYLOV_ROWS);
    for (int i = rb * KRYLOV_ROWS; i < i_end; ++i) {
      A acc = A(0);
      for (int d = 0; d < bands.n; ++d) {
        const int ii = i + bands.dr[d];
        const int jj = j + bands.dc[d];
        A xv = A(0);
        if (jj >= 0 && jj < ny) {
          if (ii >= 0 && ii < M) {
            xv = to_acc<A>(xb[(size_t)ii * ny + jj]);
          } else if (ii < 0 && top != nullptr) {
            xv = to_acc<A>(top[(size_t)(h + ii) * ny + jj]);
          } else if (ii >= M && bot != nullptr) {
            xv = to_acc<A>(bot[(size_t)(ii - M) * ny + jj]);
          }
        }
        acc += to_acc<A>(c[(size_t)d * plane + (size_t)i * ny + j]) * xv;
      }
      yb[(size_t)i * ny + j] = from_acc<TY>(acc);
    }
  }
}

template <typename TC, typename TX, typename TY, typename A>
static void launch_stencil2d(const void* c, const void* x, const void* top,
                             const void* bot, void* y, int batch, int M,
                             int ny, int h, const Bands& bands,
                             cudaStream_t stream) {
  stencil2d_kernel<TC, TX, TY, A><<<grid_2d(M, ny, batch), KRYLOV_THREADS, 0, stream>>>(
      static_cast<const TC*>(c), static_cast<const TX*>(x),
      static_cast<const TX*>(top), static_cast<const TX*>(bot),
      static_cast<TY*>(y), M, ny, h, bands);
}

// ---------------------------------------------------------------------------
// K2: constant-coefficient stencil matvec.
//
// Replaces krylov_tpu/ops/pallas_stencil.py:const_stencil2d_matvec
// (_const_kernel).  Bound on this card: memory traffic, 2 N words (x read,
// y written; no coefficient planes).  Two kernels; krylov_const_stencil2d
// sends a call to the tiled one when `tiled` is set, which the wrapper does
// from the type, the shape and the alignment alone (k2_tiled there): float
// vectors, ny a multiple of 4, x, y and the halo rows on 16-byte boundaries,
// and |dr|, |dc| up to KRYLOV_K2_MAX_HALO.  Everything else (bf16, f64 and
// complex vectors, an odd ny, an unaligned view, |dr| in the dozens as on a
// collapsed 3-D grid with a long second axis) takes the general kernel.  Both sum the bands in the order given with one
// multiply-add a term, so they agree bit for bit with each other and, on a
// Laplacian, with K1.
//
// The tiled kernel.  What bounded the general one was not bytes but the
// loads a point makes: ndiag 4-byte global loads and a 4-byte store, most
// of them re-reads served by L1.  Here each x element enters the SM once.  A
// block owns a strip of 4 * NT columns (NT threads) and marches down
// KRYLOV_K2_RUN rows, KRYLOV_K2_STEP rows a step.  It keeps a ring of 2 hr +
// KRYLOV_K2_STEP * (KRYLOV_K2_STAGES + 1) rows of the strip, widened by hc
// rounded up to 4 columns on each side, in shared memory, and fills it
// KRYLOV_K2_STAGES steps ahead with 16-byte cp.async copies, which bypass L1
// and the registers; one barrier a step.  Rows outside [0, M) enter the ring
// from the caller's halo rows or as zeros and columns outside [0, ny) as
// zeros (the copy's zero fill), so the Dirichlet column mask is a zero read;
// the row constraints are evaluated once a row (const_row_mask).  A thread
// sums four outputs a row from the ring: the columns t, t + NT, t + 2 NT,
// t + 3 NT of the strip, so that a warp's shared-memory reads and its global
// stores fall on 32 neighbouring words whatever dc is (four neighbouring
// outputs a thread would put every shifted read on a 4-way bank conflict).
// The band loop is outside and the step's rows and the four columns inside,
// so a band's set-up is paid once for 4 * KRYLOV_K2_STEP points.  Global
// loads a point: 0.25 of 16 bytes, plus 2 hr / KRYLOV_K2_RUN for the run's
// first and last rows.  Measured on an H100 80GB HBM3 (700 W) at 4096^2,
// device time inside a CUDA graph (tools/torch_kernel_sweep.py): 54.6 us at
// 5 bands, 56.3 at 9, 91.8 at 25, where the general kernel takes 64.4, 79.0
// and 162; stages 1..8, steps 1..8, runs of 32..128 rows and strips of 256
// and 1024 columns all stay within 54.6..58 us at 5 bands.  A copy of the
// same 2 N words takes 46.1 us there (the card's rate for one write per
// read) and this kernel with a single band 50.5, so the ring itself costs
// about 4 us and five bands 4.5 more; from 9 bands on shared-memory
// bandwidth (4 bytes a lane and term) takes over.
//
// The ring is filled through a source object (stage: four values of one row
// into shared memory, zeros outside the grid) and read by ring_step, so the
// fused phase A (K3: r + omega p, computed once a point) and the const
// Jacobi sweep (K8) can take the same loader with their own sources.
//
// The general kernel: K1's layout (one thread per column, KRYLOV_ROWS rows
// per block, neighbour rows read from x through L1/L2), with scalar weights
// in the by-value ConstBands and the Dirichlet masks computed in the kernel
// (const_rows).  row0 is the first global row of this slab (the masks are
// defined on global rows); halos as K1.  bf16 vectors accumulate in float
// and round once on the store; complex vectors take the real weights of
// their real type, as the reference's do.
// ---------------------------------------------------------------------------
#ifndef KRYLOV_K2_THREADS
#define KRYLOV_K2_THREADS 128  // threads of a tiled block: a strip of 4 x as many columns
#endif
#ifndef KRYLOV_K2_RUN
#define KRYLOV_K2_RUN 64  // rows a tiled block marches down
#endif
#ifndef KRYLOV_K2_STEP
#define KRYLOV_K2_STEP 2  // rows summed between two barriers
#endif
#ifndef KRYLOV_K2_STAGES
#define KRYLOV_K2_STAGES 2  // steps whose rows are in flight ahead of the one being summed
#endif
#define KRYLOV_K2_MAX_HALO 8  // the tiled kernel takes bands with |dr|, |dc| up to this
#define KRYLOV_K2_SMEM (96 * 1024)  // the most shared memory a ring may take

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;  // 0: nothing is read and 16 zero bytes are written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Ring source of K2: x, with the caller's halo rows (or zeros) outside the
// grid's rows and zeros outside its columns.  stage puts the four values of
// row g, columns gc .. gc + 3 (gc a multiple of 4, as ny is) at dst,
// asynchronously; cp_async_wait and a barrier make them visible.
struct HaloRingSrc {
  const float* __restrict__ x;
  const float* __restrict__ top;
  const float* __restrict__ bot;
  int M, ny, h;
  __device__ __forceinline__ void stage(float* dst, int g, int gc) const {
    const float* row = nullptr;
    if (g >= 0 && g < M) {
      row = x + (size_t)g * ny;
    } else if (g < 0 && top != nullptr) {
      row = top + (size_t)(h + g) * ny;
    } else if (g >= M && bot != nullptr) {
      row = bot + (size_t)(g - M) * ny;
    }
    const bool ok = row != nullptr && gc >= 0 && gc < ny;
    cp_async16(dst, ok ? row + gc : x, ok);
  }
};

// A block's ring: `depth` rows of `wp` floats; ring column 0 is grid column
// c0 - pad, and ring row s of a run is kept in slot s % depth.
struct Ring {
  float* rows;
  int depth, wp, pad, c0;
  __device__ __forceinline__ int wrap(int slot) const {
    return slot >= depth ? slot - depth : slot;
  }
};

// Stage grid rows g .. g + n - 1 into the slots from `slot` on, a 16-byte
// piece a thread and turn; rows from g_end on are left alone.
template <typename Src>
__device__ __forceinline__ void ring_fill(const Ring& ring, const Src& src, int slot, int g,
                                          int n, int g_end) {
  for (int r = 0; r < n && g + r < g_end; ++r) {
    float* dst = ring.rows + (size_t)ring.wrap(slot + r) * ring.wp;
    for (int k = threadIdx.x; 4 * k < ring.wp; k += blockDim.x) {
      src.stage(dst + 4 * k, g + r, ring.c0 - ring.pad + 4 * k);
    }
  }
}

// acc[r][k] = sum over the bands valid on row r of this step (bit d of
// ok[r]) of w[d] * the ring's value at (row + dr[d], column t + k * NT +
// dc[d]), bands in the order given, one multiply-add a term; slot0 is the
// ring slot of the step's first row less hr.  The band loop is outside and
// the step's rows and the thread's four columns are unrolled inside, so a
// band's set-up is paid once for 4 * KRYLOV_K2_STEP points.
template <bool CONS, int NT>
__device__ __forceinline__ void ring_step(const Ring& ring, const ConstBands<float>& b,
                                          int slot0, const unsigned (&ok)[KRYLOV_K2_STEP],
                                          float (&acc)[KRYLOV_K2_STEP][4]) {
#pragma unroll
  for (int r = 0; r < KRYLOV_K2_STEP; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.0f;
  }
  for (int d = 0; d < b.n; ++d) {
    const float w = b.w[d];
    const int slot = slot0 + b.hr + b.dr[d];
    const int col = ring.pad + b.dc[d] + threadIdx.x;
#pragma unroll
    for (int r = 0; r < KRYLOV_K2_STEP; ++r) {
      if (CONS && !((ok[r] >> d) & 1u)) continue;
      const float* p = ring.rows + (size_t)ring.wrap(slot + r) * ring.wp + col;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] += w * p[k * NT];
    }
  }
}

static constexpr int k2_ring_bytes(int threads, int hr, int hc) {
  return (2 * hr + KRYLOV_K2_STEP * (KRYLOV_K2_STAGES + 1)) *
         (4 * threads + 2 * ((hc + 3) & ~3)) * (int)sizeof(float);
}
static_assert(k2_ring_bytes(KRYLOV_K2_THREADS, KRYLOV_K2_MAX_HALO, KRYLOV_K2_MAX_HALO) <=
                  KRYLOV_K2_SMEM,
              "the widest ring must fit the shared memory asked for");
static_assert(KRYLOV_K2_RUN % KRYLOV_K2_STEP == 0, "a run is a whole number of steps");

template <bool CONS, int NT>
__global__ void __launch_bounds__(NT)
const_stencil2d_tiled_kernel(const float* __restrict__ x, const float* __restrict__ top,
                             const float* __restrict__ bot, float* __restrict__ y,
                             int M, int ny, int h, int row0, ConstBands<float> b) {
  extern __shared__ __align__(16) float ring_rows[];
  const int pad = (b.hc + 3) & ~3;
  const Ring ring{ring_rows, 2 * b.hr + KRYLOV_K2_STEP * (KRYLOV_K2_STAGES + 1),
                  4 * NT + 2 * pad, pad, (int)blockIdx.x * 4 * NT};
  const size_t plane = (size_t)M * ny;
  const HaloRingSrc src{x + blockIdx.z * plane, top, bot, M, ny, h};
  float* yb = y + blockIdx.z * plane;
  const int nruns = (M + KRYLOV_K2_RUN - 1) / KRYLOV_K2_RUN;
  for (int run = blockIdx.y; run < nruns; run += gridDim.y) {
    const int i0 = run * KRYLOV_K2_RUN;
    const int rows = min(KRYLOV_K2_RUN, M - i0);
    // Ring row s holds grid row i0 - hr + s; the step of output rows i0 + j ..
    // i0 + j + STEP - 1 reads s = j .. j + STEP - 1 + 2 hr.  One copy group is
    // committed a step (its STEP newest rows; the first also brings the 2 hr
    // rows above), empty once past the run's last row, so "all but the newest
    // STAGES - 1 groups have landed" always means this step's rows.
    const int g_end = i0 + rows + b.hr;  // one past the last grid row the run reads
    int g_next = i0 - b.hr, slot_next = 0;
    for (int q = 0; q < KRYLOV_K2_STAGES; ++q) {
      const int n = KRYLOV_K2_STEP + (q == 0 ? 2 * b.hr : 0);
      ring_fill(ring, src, slot_next, g_next, n, g_end);
      cp_async_commit();
      g_next += n;
      slot_next = (slot_next + n) % ring.depth;
    }
    int slot0 = 0;
    for (int j = 0; j < rows; j += KRYLOV_K2_STEP) {
      cp_async_wait<KRYLOV_K2_STAGES - 1>();
      __syncthreads();  // this step's rows are visible; the last step's oldest are free
      ring_fill(ring, src, slot_next, g_next, KRYLOV_K2_STEP, g_end);
      cp_async_commit();
      g_next += KRYLOV_K2_STEP;
      slot_next = ring.wrap(slot_next + KRYLOV_K2_STEP);
      unsigned ok[KRYLOV_K2_STEP];
#pragma unroll
      for (int r = 0; r < KRYLOV_K2_STEP; ++r) {
        ok[r] = CONS ? const_row_mask(b, row0 + i0 + j + r) : ~0u;
      }
      float acc[KRYLOV_K2_STEP][4];
      ring_step<CONS, NT>(ring, b, slot0, ok, acc);
#pragma unroll
      for (int r = 0; r < KRYLOV_K2_STEP; ++r) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int col = ring.c0 + threadIdx.x + k * NT;
          if (j + r < rows && col < ny) yb[(size_t)(i0 + j + r) * ny + col] = acc[r][k];
        }
      }
      slot0 = ring.wrap(slot0 + KRYLOV_K2_STEP);
    }
    __syncthreads();  // the next run's first copies overwrite rows still being read
  }
}

// Whether the tiled kernel takes this call: decided by the wrapper from the
// same facts (k2_tiled), checked here because a misaligned 16-byte copy
// faults.
static bool k2_tiled_ok(const void* x, const void* top, const void* bot, const void* y,
                        int ny, const ConstBands<float>& b) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(top) | reinterpret_cast<uintptr_t>(bot);
  return ny % 4 == 0 && bits % 16 == 0 && b.hr <= KRYLOV_K2_MAX_HALO &&
         b.hc <= KRYLOV_K2_MAX_HALO;
}

template <int NT>
static int launch_const_stencil2d_tiled(const float* x, const float* top, const float* bot,
                                        float* y, int batch, int M, int ny, int h, int row0,
                                        const ConstBands<float>& b, cudaStream_t s) {
  int gy = (M + KRYLOV_K2_RUN - 1) / KRYLOV_K2_RUN;
  if (gy > KRYLOV_MAX_GRID_Y) gy = KRYLOV_MAX_GRID_Y;
  const dim3 g((ny + 4 * NT - 1) / (4 * NT), gy, batch);
  const auto kernel = b.any_cons ? const_stencil2d_tiled_kernel<true, NT>
                                 : const_stencil2d_tiled_kernel<false, NT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KRYLOV_K2_SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<g, NT, k2_ring_bytes(NT, b.hr, b.hc), s>>>(x, top, bot, y, M, ny, h, row0, b);
  return (int)cudaGetLastError();
}

template <bool CONS, typename TX, typename A, typename W>
__global__ void __launch_bounds__(KRYLOV_THREADS)
const_stencil2d_kernel(const TX* __restrict__ x, const TX* __restrict__ top,
                       const TX* __restrict__ bot, TX* __restrict__ y, int M,
                       int ny, int h, int row0, ConstBands<W> bands) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ny) return;
  const size_t plane = (size_t)M * ny;
  const HaloSrc<TX, A> src{x + (size_t)blockIdx.z * plane, top, bot, M, ny, h};
  TX* yb = y + (size_t)blockIdx.z * plane;
  const int nrb = (M + KRYLOV_ROWS - 1) / KRYLOV_ROWS;
  for (int rb = blockIdx.y; rb < nrb; rb += gridDim.y) {
    const int i0 = rb * KRYLOV_ROWS;
    A acc[KRYLOV_ROWS];
    const_rows<CONS>(bands, src, i0, j, M, ny, row0, acc);
#pragma unroll
    for (int r = 0; r < KRYLOV_ROWS; ++r) {
      if (i0 + r < M) yb[(size_t)(i0 + r) * ny + j] = from_acc<TX>(acc[r]);
    }
  }
}

template <typename TX, typename A, typename W>
static void launch_const_stencil2d(const void* x, const void* top, const void* bot,
                                   void* y, int batch, int M, int ny, int h,
                                   int row0, const ConstBands<W>& b,
                                   cudaStream_t s) {
  const dim3 g = grid_2d(M, ny, batch);
  const TX* xt = static_cast<const TX*>(x);
  const TX* tt = static_cast<const TX*>(top);
  const TX* bt = static_cast<const TX*>(bot);
  TX* yt = static_cast<TX*>(y);
  if (b.any_cons) {
    const_stencil2d_kernel<true, TX, A, W><<<g, KRYLOV_THREADS, 0, s>>>(xt, tt, bt, yt, M, ny, h, row0, b);
  } else {
    const_stencil2d_kernel<false, TX, A, W><<<g, KRYLOV_THREADS, 0, s>>>(xt, tt, bt, yt, M, ny, h, row0, b);
  }
}

// ---------------------------------------------------------------------------
// K5: fused CG phase A, variable coefficients (f32).
//
// Replaces krylov_tpu/ops/pallas_stencil.py:cg_fused_phase_a_var
// (_cg_a_var_kernel).  Computes p_new = r + omega * p, Ap = A p_new and one
// partial <p_new, Ap> per block.  Bound on this card: memory traffic,
// (ndiag + 4) * N words (planes, r, p read; p_new, Ap written).  Design: as
// K1, with the p-update recomputed at every neighbour read (outside the grid
// it is 0 + omega * 0 = 0, so no halo input is needed); p_new goes to a
// buffer that is neither r nor p, since other blocks still read p; omega is
// read through a device pointer, so the host never waits for it.  The
// partials are summed by finalize_sum in a fixed order: no float atomics,
// so a solve repeats bit for bit.
//
// K6: fused Jacobi-preconditioned CG phase A, variable coefficients (f32).
//
// Replaces krylov_tpu/ops/pallas_stencil.py:cg_fused_phase_a_var_jac
// (_cg_a_var_jac_kernel).  K5 with the direction update p_new = dinv * r +
// omega * p, dinv = 1 / diag(A) as one more plane.  Bound on this card:
// memory traffic, (ndiag + 5) * N words (planes, dinv, r, p read; p_new, Ap
// written).  Design: the same kernel template as K5 (JAC = true); the
// update is recomputed at every neighbour read as dinv[q] * r[q] + omega *
// p[q], and is 0 outside the grid (the TPU kernel gets that from zero dinv
// halo rows), so no halo input is needed.  Measured at 4096^2, five bands,
// on an H100 80GB HBM3 (700 W): 316 us, 63 % of that bound, where K5
// reaches 79 %: a point makes 23 loads (three per neighbour read) against
// K5's 17, and the time grew with the loads, not with the bytes.
// ---------------------------------------------------------------------------
template <bool JAC>
__global__ void __launch_bounds__(KRYLOV_THREADS)
cg_phase_a_var_kernel(const float* __restrict__ omega,
                      const float* __restrict__ c, const float* __restrict__ r,
                      const float* __restrict__ p,
                      const float* __restrict__ dinv, float* __restrict__ pn,
                      float* __restrict__ ap, float* __restrict__ partials,
                      int M, int ny, Bands bands) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const float om = *omega;
  const size_t plane = (size_t)M * ny;
  float part = 0.0f;
  if (j < ny) {
    const int nrb = (M + KRYLOV_ROWS - 1) / KRYLOV_ROWS;
    for (int rb = blockIdx.y; rb < nrb; rb += gridDim.y) {
      const int i_end = min(M, (rb + 1) * KRYLOV_ROWS);
      for (int i = rb * KRYLOV_ROWS; i < i_end; ++i) {
        float acc = 0.0f;
        for (int d = 0; d < bands.n; ++d) {
          const int ii = i + bands.dr[d];
          const int jj = j + bands.dc[d];
          float v = 0.0f;
          if (ii >= 0 && ii < M && jj >= 0 && jj < ny) {
            const size_t q = (size_t)ii * ny + jj;
            v = (JAC ? dinv[q] * r[q] : r[q]) + om * p[q];
          }
          acc += c[(size_t)d * plane + (size_t)i * ny + j] * v;
        }
        const size_t q = (size_t)i * ny + j;
        const float pc = (JAC ? dinv[q] * r[q] : r[q]) + om * p[q];
        pn[q] = pc;
        ap[q] = acc;
        part += pc * acc;
      }
    }
  }
  part = block_sum(part);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = part;
}

// ---------------------------------------------------------------------------
// K3: fused CG phase A, constant coefficients (f32).
//
// Replaces krylov_tpu/ops/pallas_stencil.py:cg_fused_phase_a (_cg_a_kernel).
// Computes p_new = r + omega * p, Ap = A_const p_new (masked in the kernel)
// and one partial <p_new, Ap> per block.  Bound on this card: memory
// traffic, 4 N words (r, p read; p_new, Ap written).  Design: K5 with K2's
// const bands (const_rows over the p-update).  The TPU writes p_new into
// p's buffer (input_output_aliases={2: 0}); here other blocks still read
// p's neighbour rows, so p_new goes to a separate buffer and cg_stencil
// ping-pongs two.
// ---------------------------------------------------------------------------
template <bool CONS>
__global__ void __launch_bounds__(KRYLOV_THREADS)
cg_phase_a_const_kernel(const float* __restrict__ omega,
                        const float* __restrict__ r,
                        const float* __restrict__ p, float* __restrict__ pn,
                        float* __restrict__ ap, float* __restrict__ partials,
                        int M, int ny, ConstBands<float> bands) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const PUpdateSrc src{r, p, *omega};
  float part = 0.0f;
  if (j < ny) {
    const int nrb = (M + KRYLOV_ROWS - 1) / KRYLOV_ROWS;
    for (int rb = blockIdx.y; rb < nrb; rb += gridDim.y) {
      const int i0 = rb * KRYLOV_ROWS;
      float acc[KRYLOV_ROWS];
      const_rows<CONS>(bands, src, i0, j, M, ny, 0, acc);
#pragma unroll
      for (int k = 0; k < KRYLOV_ROWS; ++k) {
        if (i0 + k < M) {
          const long long q = (long long)(i0 + k) * ny + j;
          const float pc = src.at(q);
          pn[q] = pc;
          ap[q] = acc[k];
          part += pc * acc[k];
        }
      }
    }
  }
  part = block_sum(part);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = part;
}

// ---------------------------------------------------------------------------
// K8: damped-Jacobi sweep, constant coefficients (f32, f64, complex64,
// complex128; the weights and w are real).
//
// Replaces krylov_tpu/ops/pallas_stencil.py:jacobi_sweep_const
// (_jacobi_sweep_kernel).  update != 0: out = z + w * (r - A z); update ==
// 0: out = r - A z (w unread).  Bound on this card: memory traffic, 3 N
// words (z, r read; out written).  Design: K2's layout and masks
// (const_rows); out must be neither z nor r (the TPU writes z' into z's
// buffer, a race here since other blocks read z's neighbour rows): the
// multigrid smoother alternates two buffers per level.
// ---------------------------------------------------------------------------
template <bool CONS, typename T, typename W>
__global__ void __launch_bounds__(KRYLOV_THREADS)
jacobi_const_kernel(W w, const T* __restrict__ z, const T* __restrict__ r,
                    T* __restrict__ out, int update, int M, int ny,
                    ConstBands<W> bands) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ny) return;
  const ZeroSrc<T> src{z};
  const int nrb = (M + KRYLOV_ROWS - 1) / KRYLOV_ROWS;
  for (int rb = blockIdx.y; rb < nrb; rb += gridDim.y) {
    const int i0 = rb * KRYLOV_ROWS;
    T acc[KRYLOV_ROWS];
    const_rows<CONS>(bands, src, i0, j, M, ny, 0, acc);
#pragma unroll
    for (int k = 0; k < KRYLOV_ROWS; ++k) {
      if (i0 + k < M) {
        const size_t q = (size_t)(i0 + k) * ny + j;
        const T res = r[q] - acc[k];
        out[q] = update ? z[q] + w * res : res;
      }
    }
  }
}

template <typename T, typename W>
static void launch_jacobi_const(W w, const void* z, const void* r, void* out,
                                int update, int M, int ny, const ConstBands<W>& b,
                                cudaStream_t s) {
  const dim3 g = grid_2d(M, ny, 1);
  const T* zt = static_cast<const T*>(z);
  const T* rt = static_cast<const T*>(r);
  T* ot = static_cast<T*>(out);
  if (b.any_cons) {
    jacobi_const_kernel<true, T, W><<<g, KRYLOV_THREADS, 0, s>>>(w, zt, rt, ot, update, M, ny, b);
  } else {
    jacobi_const_kernel<false, T, W><<<g, KRYLOV_THREADS, 0, s>>>(w, zt, rt, ot, update, M, ny, b);
  }
}

// ---------------------------------------------------------------------------
// K9: damped-Jacobi sweep, variable coefficients (f32, f64, complex64,
// complex128 vectors; the planes c and w are real or of the vector's type).
//
// Replaces krylov_tpu/ops/pallas_stencil.py:jacobi_sweep_var
// (_jacobi_sweep_var_kernel).  w != null: out = z + w * (r - A z) with a
// per-point weight plane w = omega / diag; w == null: out = r - A z, and
// the plane is not streamed.  Bound on this card: memory traffic,
// (ndiag + 4) N words in update mode (planes, w, z, r read; out written),
// (ndiag + 3) N as a residual.  Design: K1's layout and loop; up to
// KRYLOV_MAX_BANDS bands (the Galerkin levels of the multigrid hierarchy
// have 25, |dr|, |dc| <= 2); out must be neither z nor r, as K8.
// ---------------------------------------------------------------------------
template <typename TC, typename T>
__global__ void __launch_bounds__(KRYLOV_THREADS)
jacobi_var_kernel(const TC* __restrict__ c, const TC* __restrict__ w,
                  const T* __restrict__ z, const T* __restrict__ r,
                  T* __restrict__ out, int M, int ny, Bands bands) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ny) return;
  const size_t plane = (size_t)M * ny;
  const int nrb = (M + KRYLOV_ROWS - 1) / KRYLOV_ROWS;
  for (int rb = blockIdx.y; rb < nrb; rb += gridDim.y) {
    const int i_end = min(M, (rb + 1) * KRYLOV_ROWS);
    for (int i = rb * KRYLOV_ROWS; i < i_end; ++i) {
      T acc = T(0);
      for (int d = 0; d < bands.n; ++d) {
        const int ii = i + bands.dr[d];
        const int jj = j + bands.dc[d];
        T zv = T(0);
        if (jj >= 0 && jj < ny && ii >= 0 && ii < M) zv = z[(size_t)ii * ny + jj];
        acc += c[(size_t)d * plane + (size_t)i * ny + j] * zv;
      }
      const size_t q = (size_t)i * ny + j;
      const T res = r[q] - acc;
      out[q] = w != nullptr ? z[q] + w[q] * res : res;
    }
  }
}

// ---------------------------------------------------------------------------
// K4: fused CG phase B (f32).
//
// Replaces krylov_tpu/ops/pallas_stencil.py:cg_fused_phase_b (_cg_b_kernel).
// y += alpha p and r -= alpha Ap in place, one partial <r, r> per block.
// Bound on this card: memory traffic, 6 N words (y, r, p, Ap read; y, r
// written).  Design: purely elementwise, so in-place is safe; a fixed
// number of blocks strides over the vectors, so the partials (and the
// fixed-order finalize_sum over them) are deterministic; alpha is read
// through a device pointer.
//
// K7: fused Jacobi-preconditioned CG phase B (f32).
//
// Replaces krylov_tpu/ops/pallas_stencil.py:cg_fused_phase_b_jac
// (_cg_b_jac_kernel).  K4 with rho = <r_new, dinv * r_new>, summed as
// r_new * (dinv * r_new), the reference's association.  Bound on this card:
// memory traffic, 7 N words (K4's and the dinv plane).  Design: the same
// kernel template as K4 (JAC = true), the same fixed block count and
// fixed-order second pass.
// ---------------------------------------------------------------------------
template <bool JAC>
__global__ void __launch_bounds__(KRYLOV_THREADS)
cg_phase_b_kernel(const float* __restrict__ alpha, float* __restrict__ y,
                  float* __restrict__ r, const float* __restrict__ p,
                  const float* __restrict__ ap, const float* __restrict__ dinv,
                  float* __restrict__ partials, long long n) {
  const float al = *alpha;
  float part = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += stride) {
    const float rn = r[q] - al * ap[q];
    y[q] = y[q] + al * p[q];
    r[q] = rn;
    part += JAC ? rn * (dinv[q] * rn) : rn * rn;
  }
  part = block_sum(part);
  if (threadIdx.x == 0) partials[blockIdx.x] = part;
}

// Second pass of K3, K5, K6, K4 and K7: one block sums the per-block partials
// in a fixed order, in double, and stores the f32 result.
__global__ void __launch_bounds__(1024)
finalize_sum(const float* __restrict__ partials, int n, float* __restrict__ out) {
  double s = 0.0;
  for (int q = threadIdx.x; q < n; q += blockDim.x) s += (double)partials[q];
  s = block_sum(s);
  if (threadIdx.x == 0) *out = (float)s;
}

static int phase_b_blocks(long long n) {
  long long b = (n + KRYLOV_THREADS - 1) / KRYLOV_THREADS;
  if (b > KRYLOV_PHASE_B_BLOCKS) b = KRYLOV_PHASE_B_BLOCKS;
  return b < 1 ? 1 : (int)b;
}

template <typename TC, typename T>
static void launch_jacobi_var(const void* c, const void* w, const void* z,
                              const void* r, void* out, int M, int ny,
                              const Bands& bands, cudaStream_t s) {
  jacobi_var_kernel<TC, T><<<grid_2d(M, ny, 1), KRYLOV_THREADS, 0, s>>>(
      static_cast<const TC*>(c), static_cast<const TC*>(w),
      static_cast<const T*>(z), static_cast<const T*>(r), static_cast<T*>(out),
      M, ny, bands);
}

extern "C" {

const char* krylov_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int krylov_max_bands() { return KRYLOV_MAX_BANDS; }

int krylov_max_constraints() { return KRYLOV_MAX_CONSTRAINTS; }

long long krylov_phase_a_partials(int M, int ny) {
  const dim3 g = grid_2d(M, ny, 1);
  return (long long)g.x * g.y;
}

long long krylov_phase_b_partials(long long n) { return phase_b_blocks(n); }

// K1.  tc/tx: dtype codes of c and x; y has the promoted type (f32 for
// f32/bf16 mixes, bf16 for bf16/bf16, f64 for f64/f64, the complex type
// when either side is complex).  x and y hold `batch` grids back to back;
// top/bot are (h, ny) rows or null.
int krylov_stencil2d(int tc, int tx, const void* c, const void* x,
                     const void* top, const void* bot, void* y, int batch,
                     int M, int ny, int ndiag, const int* dr, const int* dc,
                     int h, void* stream) {
  Bands bands;
  if (!make_bands(ndiag, dr, dc, &bands) || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc == KRYLOV_F32 && tx == KRYLOV_F32) {
    launch_stencil2d<float, float, float, float>(c, x, top, bot, y, batch, M, ny, h, bands, s);
  } else if (tc == KRYLOV_BF16 && tx == KRYLOV_BF16) {
    launch_stencil2d<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, float>(
        c, x, top, bot, y, batch, M, ny, h, bands, s);
  } else if (tc == KRYLOV_BF16 && tx == KRYLOV_F32) {
    launch_stencil2d<__nv_bfloat16, float, float, float>(c, x, top, bot, y, batch, M, ny, h, bands, s);
  } else if (tc == KRYLOV_F32 && tx == KRYLOV_BF16) {
    launch_stencil2d<float, __nv_bfloat16, float, float>(c, x, top, bot, y, batch, M, ny, h, bands, s);
  } else if (tc == KRYLOV_F64 && tx == KRYLOV_F64) {
    launch_stencil2d<double, double, double, double>(c, x, top, bot, y, batch, M, ny, h, bands, s);
  } else if (tc == KRYLOV_C64 && tx == KRYLOV_C64) {
    launch_stencil2d<c64, c64, c64, c64>(c, x, top, bot, y, batch, M, ny, h, bands, s);
  } else if (tc == KRYLOV_F32 && tx == KRYLOV_C64) {
    launch_stencil2d<float, c64, c64, c64>(c, x, top, bot, y, batch, M, ny, h, bands, s);
  } else if (tc == KRYLOV_C128 && tx == KRYLOV_C128) {
    launch_stencil2d<c128, c128, c128, c128>(c, x, top, bot, y, batch, M, ny, h, bands, s);
  } else if (tc == KRYLOV_F64 && tx == KRYLOV_C128) {
    launch_stencil2d<double, c128, c128, c128>(c, x, top, bot, y, batch, M, ny, h, bands, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int krylov_k2_max_halo() { return KRYLOV_K2_MAX_HALO; }

// K2.  tx: dtype code of x (and y).  The const bands come as ndiag entries
// of dr, dc, w and ncons, and KRYLOV_MAX_CONSTRAINTS (stride, size, step)
// triples per band in cons.  tiled: take the tiled kernel (float vectors,
// ny % 4 == 0, every pointer on a 16-byte boundary, |dr| and |dc| up to
// krylov_k2_max_halo(); anything else is refused), else the general one.
int krylov_const_stencil2d(int tx, int tiled, const void* x, const void* top,
                           const void* bot, void* y, int batch, int M, int ny,
                           int h, int row0, int ndiag, const int* dr,
                           const int* dc, const double* w, const int* ncons,
                           const int* cons, void* stream) {
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tx == KRYLOV_F32 || tx == KRYLOV_BF16) {
    ConstBands<float> b;
    if (!make_const_bands(ndiag, dr, dc, w, ncons, cons, &b)) return (int)cudaErrorInvalidValue;
    if (tiled) {
      if (tx != KRYLOV_F32 || !k2_tiled_ok(x, top, bot, y, ny, b)) {
        return (int)cudaErrorInvalidValue;
      }
      const float* xf = static_cast<const float*>(x);
      const float* tf = static_cast<const float*>(top);
      const float* bf = static_cast<const float*>(bot);
      float* yf = static_cast<float*>(y);
      if (ny <= 4 * 32) {  // a strip no wider than a narrow grid
        return launch_const_stencil2d_tiled<32>(xf, tf, bf, yf, batch, M, ny, h, row0, b, s);
      }
      return launch_const_stencil2d_tiled<KRYLOV_K2_THREADS>(xf, tf, bf, yf, batch, M, ny, h,
                                                             row0, b, s);
    }
    if (tx == KRYLOV_F32) {
      launch_const_stencil2d<float, float>(x, top, bot, y, batch, M, ny, h, row0, b, s);
    } else {
      launch_const_stencil2d<__nv_bfloat16, float>(x, top, bot, y, batch, M, ny, h, row0, b, s);
    }
  } else if (tiled) {
    return (int)cudaErrorInvalidValue;
  } else if (tx == KRYLOV_F64) {
    ConstBands<double> b;
    if (!make_const_bands(ndiag, dr, dc, w, ncons, cons, &b)) return (int)cudaErrorInvalidValue;
    launch_const_stencil2d<double, double>(x, top, bot, y, batch, M, ny, h, row0, b, s);
  } else if (tx == KRYLOV_C64) {
    ConstBands<float> b;
    if (!make_const_bands(ndiag, dr, dc, w, ncons, cons, &b)) return (int)cudaErrorInvalidValue;
    launch_const_stencil2d<c64, c64>(x, top, bot, y, batch, M, ny, h, row0, b, s);
  } else if (tx == KRYLOV_C128) {
    ConstBands<double> b;
    if (!make_const_bands(ndiag, dr, dc, w, ncons, cons, &b)) return (int)cudaErrorInvalidValue;
    launch_const_stencil2d<c128, c128>(x, top, bot, y, batch, M, ny, h, row0, b, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K3.  `partials` holds krylov_phase_a_partials(M, ny) floats; *pap gets
// <p_new, Ap>.
int krylov_cg_phase_a_const(const float* omega, const float* r, const float* p,
                            float* pn, float* ap, float* partials, float* pap,
                            int M, int ny, int ndiag, const int* dr,
                            const int* dc, const double* w, const int* ncons,
                            const int* cons, void* stream) {
  ConstBands<float> b;
  if (!make_const_bands(ndiag, dr, dc, w, ncons, cons, &b)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g = grid_2d(M, ny, 1);
  if (b.any_cons) {
    cg_phase_a_const_kernel<true><<<g, KRYLOV_THREADS, 0, s>>>(omega, r, p, pn, ap,
                                                               partials, M, ny, b);
  } else {
    cg_phase_a_const_kernel<false><<<g, KRYLOV_THREADS, 0, s>>>(omega, r, p, pn, ap,
                                                                partials, M, ny, b);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_sum<<<1, 1024, 0, s>>>(partials, (int)(g.x * g.y), pap);
  return (int)cudaGetLastError();
}

// K8.  tz: dtype code of z, r and out (f32, f64, c64, c128); w is the
// Jacobi weight, rounded to the real type.
int krylov_jacobi_sweep_const(int tz, double w, const void* z, const void* r,
                              void* out, int update, int M, int ny, int ndiag,
                              const int* dr, const int* dc, const double* wts,
                              const int* ncons, const int* cons, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tz == KRYLOV_F32) {
    ConstBands<float> b;
    if (!make_const_bands(ndiag, dr, dc, wts, ncons, cons, &b)) return (int)cudaErrorInvalidValue;
    launch_jacobi_const<float>((float)w, z, r, out, update, M, ny, b, s);
  } else if (tz == KRYLOV_F64) {
    ConstBands<double> b;
    if (!make_const_bands(ndiag, dr, dc, wts, ncons, cons, &b)) return (int)cudaErrorInvalidValue;
    launch_jacobi_const<double>(w, z, r, out, update, M, ny, b, s);
  } else if (tz == KRYLOV_C64) {
    ConstBands<float> b;
    if (!make_const_bands(ndiag, dr, dc, wts, ncons, cons, &b)) return (int)cudaErrorInvalidValue;
    launch_jacobi_const<c64>((float)w, z, r, out, update, M, ny, b, s);
  } else if (tz == KRYLOV_C128) {
    ConstBands<double> b;
    if (!make_const_bands(ndiag, dr, dc, wts, ncons, cons, &b)) return (int)cudaErrorInvalidValue;
    launch_jacobi_const<c128>(w, z, r, out, update, M, ny, b, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K9.  tc: dtype code of the planes c and w; tz: of z, r and out.  The pairs
// are K1's: (f32, f32), (f64, f64), (c64, c64), (f32, c64), (c128, c128),
// (f64, c128).  w is null in residual mode.
int krylov_jacobi_sweep_var(int tc, int tz, const void* c, const void* w,
                            const void* z, const void* r, void* out, int M,
                            int ny, int ndiag, const int* dr, const int* dc,
                            void* stream) {
  Bands bands;
  if (!make_bands(ndiag, dr, dc, &bands)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc == KRYLOV_F32 && tz == KRYLOV_F32) {
    launch_jacobi_var<float, float>(c, w, z, r, out, M, ny, bands, s);
  } else if (tc == KRYLOV_F64 && tz == KRYLOV_F64) {
    launch_jacobi_var<double, double>(c, w, z, r, out, M, ny, bands, s);
  } else if (tc == KRYLOV_C64 && tz == KRYLOV_C64) {
    launch_jacobi_var<c64, c64>(c, w, z, r, out, M, ny, bands, s);
  } else if (tc == KRYLOV_F32 && tz == KRYLOV_C64) {
    launch_jacobi_var<float, c64>(c, w, z, r, out, M, ny, bands, s);
  } else if (tc == KRYLOV_C128 && tz == KRYLOV_C128) {
    launch_jacobi_var<c128, c128>(c, w, z, r, out, M, ny, bands, s);
  } else if (tc == KRYLOV_F64 && tz == KRYLOV_C128) {
    launch_jacobi_var<double, c128>(c, w, z, r, out, M, ny, bands, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K5 (dinv == null) and K6 (dinv: the (M, ny) plane 1 / diag(A)).
// `partials` holds krylov_phase_a_partials(M, ny) floats; *pap gets
// <p_new, Ap>.
static int cg_phase_a_var(const float* omega, const float* c, const float* r,
                          const float* p, const float* dinv, float* pn,
                          float* ap, float* partials, float* pap, int M,
                          int ny, int ndiag, const int* dr, const int* dc,
                          void* stream) {
  Bands bands;
  if (!make_bands(ndiag, dr, dc, &bands)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g = grid_2d(M, ny, 1);
  if (dinv != nullptr) {
    cg_phase_a_var_kernel<true><<<g, KRYLOV_THREADS, 0, s>>>(
        omega, c, r, p, dinv, pn, ap, partials, M, ny, bands);
  } else {
    cg_phase_a_var_kernel<false><<<g, KRYLOV_THREADS, 0, s>>>(
        omega, c, r, p, dinv, pn, ap, partials, M, ny, bands);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_sum<<<1, 1024, 0, s>>>(partials, (int)(g.x * g.y), pap);
  return (int)cudaGetLastError();
}

// K4 (dinv == null) and K7.  `partials` holds krylov_phase_b_partials(n)
// floats; *rho gets <r_new, r_new> or <r_new, dinv * r_new>.
static int cg_phase_b(const float* alpha, float* y, float* r, const float* p,
                      const float* ap, const float* dinv, float* partials,
                      float* rho, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = phase_b_blocks(n);
  if (dinv != nullptr) {
    cg_phase_b_kernel<true><<<blocks, KRYLOV_THREADS, 0, s>>>(
        alpha, y, r, p, ap, dinv, partials, n);
  } else {
    cg_phase_b_kernel<false><<<blocks, KRYLOV_THREADS, 0, s>>>(
        alpha, y, r, p, ap, dinv, partials, n);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_sum<<<1, 1024, 0, s>>>(partials, blocks, rho);
  return (int)cudaGetLastError();
}

int krylov_cg_phase_a_var(const float* omega, const float* c, const float* r,
                          const float* p, float* pn, float* ap,
                          float* partials, float* pap, int M, int ny,
                          int ndiag, const int* dr, const int* dc,
                          void* stream) {
  return cg_phase_a_var(omega, c, r, p, nullptr, pn, ap, partials, pap, M, ny,
                        ndiag, dr, dc, stream);
}

int krylov_cg_phase_a_var_jac(const float* omega, const float* c,
                              const float* r, const float* p,
                              const float* dinv, float* pn, float* ap,
                              float* partials, float* pap, int M, int ny,
                              int ndiag, const int* dr, const int* dc,
                              void* stream) {
  if (dinv == nullptr) return (int)cudaErrorInvalidValue;
  return cg_phase_a_var(omega, c, r, p, dinv, pn, ap, partials, pap, M, ny,
                        ndiag, dr, dc, stream);
}

int krylov_cg_phase_b(const float* alpha, float* y, float* r, const float* p,
                      const float* ap, float* partials, float* rho,
                      long long n, void* stream) {
  return cg_phase_b(alpha, y, r, p, ap, nullptr, partials, rho, n, stream);
}

int krylov_cg_phase_b_jac(const float* alpha, float* y, float* r,
                          const float* p, const float* ap, const float* dinv,
                          float* partials, float* rho, long long n,
                          void* stream) {
  if (dinv == nullptr) return (int)cudaErrorInvalidValue;
  return cg_phase_b(alpha, y, r, p, ap, dinv, partials, rho, n, stream);
}

}  // extern "C"
