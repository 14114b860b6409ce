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

// Sum of one value per thread over the block, in a fixed order (shuffle tree
// inside each warp, then warp 0 over the warp sums): deterministic.
template <typename A>
__device__ A block_sum(A v) {
  __shared__ A warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < nwarps) ? warp_sums[lane] : A(0);
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // valid in thread 0
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
// y written; no coefficient planes).  Design: K1's layout (one thread per
// column, KRYLOV_ROWS rows per block, neighbour rows read from x through
// L1/L2), with scalar weights in the by-value ConstBands and the Dirichlet
// masks computed in the kernel (const_rows): the row constraints once per
// row, the column bound as a zero read.  row0 is the first global row of
// this slab (the masks are defined on global rows); halos as K1.  bf16
// vectors accumulate in float and round once on the store; complex vectors
// take the real weights of their real type, as the reference's do.
// ---------------------------------------------------------------------------
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

// K2.  tx: dtype code of x (and y).  The const bands come as ndiag entries
// of dr, dc, w and ncons, and KRYLOV_MAX_CONSTRAINTS (stride, size, step)
// triples per band in cons.
int krylov_const_stencil2d(int tx, const void* x, const void* top,
                           const void* bot, void* y, int batch, int M, int ny,
                           int h, int row0, int ndiag, const int* dr,
                           const int* dc, const double* w, const int* ncons,
                           const int* cons, void* stream) {
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tx == KRYLOV_F32 || tx == KRYLOV_BF16) {
    ConstBands<float> b;
    if (!make_const_bands(ndiag, dr, dc, w, ncons, cons, &b)) return (int)cudaErrorInvalidValue;
    if (tx == KRYLOV_F32) {
      launch_const_stencil2d<float, float>(x, top, bot, y, batch, M, ny, h, row0, b, s);
    } else {
      launch_const_stencil2d<__nv_bfloat16, float>(x, top, bot, y, batch, M, ny, h, row0, b, s);
    }
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
