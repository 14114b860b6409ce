// Hand-written Hopper (sm_90a) kernels for the grid-stencil CG slice.
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
// columns j + dc outside [0, ny) are zero.  Dirichlet masking lives in the
// coefficient data: the constructors zero every coefficient whose neighbour
// leaves the grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define KRYLOV_MAX_BANDS 32
#define KRYLOV_THREADS 256  // threads per block, laid along ny
#define KRYLOV_ROWS 8       // grid rows each block walks in its row loop
#define KRYLOV_MAX_GRID_Y 65535
#define KRYLOV_PHASE_B_BLOCKS 2112  // 16 blocks per SM of the H100's 132

struct Bands {
  int n;
  int dr[KRYLOV_MAX_BANDS];
  int dc[KRYLOV_MAX_BANDS];
};

static Bands make_bands(int ndiag, const int* dr, const int* dc) {
  Bands b;
  b.n = ndiag;
  for (int d = 0; d < ndiag; ++d) {
    b.dr[d] = dr[d];
    b.dc[d] = dc[d];
  }
  return b;
}

template <typename A, typename T>
__device__ __forceinline__ A to_acc(T v) { return static_cast<A>(v); }
template <>
__device__ __forceinline__ float to_acc<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename A>
__device__ __forceinline__ T from_acc(A v) { return static_cast<T>(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(float v) {
  return __float2bfloat16(v);
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
// Accumulates in A (float for f32/bf16, double for f64), stores TY.
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
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(KRYLOV_THREADS)
cg_phase_a_var_kernel(const float* __restrict__ omega,
                      const float* __restrict__ c, const float* __restrict__ r,
                      const float* __restrict__ p, float* __restrict__ pn,
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
            v = r[q] + om * p[q];
          }
          acc += c[(size_t)d * plane + (size_t)i * ny + j] * v;
        }
        const size_t q = (size_t)i * ny + j;
        const float pc = r[q] + om * p[q];
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
// K4: fused CG phase B (f32).
//
// Replaces krylov_tpu/ops/pallas_stencil.py:cg_fused_phase_b (_cg_b_kernel).
// y += alpha p and r -= alpha Ap in place, one partial <r, r> per block.
// Bound on this card: memory traffic, 6 N words (y, r, p, Ap read; y, r
// written).  Design: purely elementwise, so in-place is safe; a fixed
// number of blocks strides over the vectors, so the partials (and the
// fixed-order finalize_sum over them) are deterministic; alpha is read
// through a device pointer.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(KRYLOV_THREADS)
cg_phase_b_kernel(const float* __restrict__ alpha, float* __restrict__ y,
                  float* __restrict__ r, const float* __restrict__ p,
                  const float* __restrict__ ap, float* __restrict__ partials,
                  long long n) {
  const float al = *alpha;
  float part = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += stride) {
    const float rn = r[q] - al * ap[q];
    y[q] = y[q] + al * p[q];
    r[q] = rn;
    part += rn * rn;
  }
  part = block_sum(part);
  if (threadIdx.x == 0) partials[blockIdx.x] = part;
}

// Second pass of K5 and K4: one block sums the per-block partials in a
// fixed order, in double, and stores the f32 result.
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

// dtype codes, shared with cuda_stencil.py
enum { KRYLOV_F32 = 0, KRYLOV_BF16 = 1, KRYLOV_F64 = 2 };

extern "C" {

const char* krylov_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int krylov_max_bands() { return KRYLOV_MAX_BANDS; }

long long krylov_phase_a_partials(int M, int ny) {
  const dim3 g = grid_2d(M, ny, 1);
  return (long long)g.x * g.y;
}

long long krylov_phase_b_partials(long long n) { return phase_b_blocks(n); }

// K1.  tc/tx: dtype codes of c and x; y has the promoted type (f32 for
// f32/bf16 mixes, bf16 for bf16/bf16, f64 for f64/f64).  x and y hold
// `batch` grids back to back; top/bot are (h, ny) rows or null.
int krylov_stencil2d(int tc, int tx, const void* c, const void* x,
                     const void* top, const void* bot, void* y, int batch,
                     int M, int ny, int ndiag, const int* dr, const int* dc,
                     int h, void* stream) {
  if (ndiag < 1 || ndiag > KRYLOV_MAX_BANDS || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const Bands bands = make_bands(ndiag, dr, dc);
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
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K5.  `partials` holds krylov_phase_a_partials(M, ny) floats; *pap gets
// <p_new, Ap>.
int krylov_cg_phase_a_var(const float* omega, const float* c, const float* r,
                          const float* p, float* pn, float* ap,
                          float* partials, float* pap, int M, int ny,
                          int ndiag, const int* dr, const int* dc,
                          void* stream) {
  if (ndiag < 1 || ndiag > KRYLOV_MAX_BANDS) return (int)cudaErrorInvalidValue;
  const Bands bands = make_bands(ndiag, dr, dc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g = grid_2d(M, ny, 1);
  cg_phase_a_var_kernel<<<g, KRYLOV_THREADS, 0, s>>>(omega, c, r, p, pn, ap,
                                                     partials, M, ny, bands);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_sum<<<1, 1024, 0, s>>>(partials, (int)(g.x * g.y), pap);
  return (int)cudaGetLastError();
}

// K4.  `partials` holds krylov_phase_b_partials(n) floats; *rho gets
// <r_new, r_new>.
int krylov_cg_phase_b(const float* alpha, float* y, float* r, const float* p,
                      const float* ap, float* partials, float* rho,
                      long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = phase_b_blocks(n);
  cg_phase_b_kernel<<<blocks, KRYLOV_THREADS, 0, s>>>(alpha, y, r, p, ap,
                                                      partials, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_sum<<<1, 1024, 0, s>>>(partials, blocks, rho);
  return (int)cudaGetLastError();
}

}  // extern "C"
