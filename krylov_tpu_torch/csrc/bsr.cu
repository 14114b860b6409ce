// Hand-written Hopper (sm_90a) kernel for block-sparse (BSR) operators:
// K12, Y = A X for ELL-padded BSR.
//
// Plain C interface, loaded with ctypes (krylov_tpu_torch/ops/cuda_bsr.py).
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
//
// Format (the reference's): data (nbrows * max_blocks, R, C) row-major
// blocks, block row i's blocks at i * max_blocks ...; cols (nbrows,
// max_blocks) int32 block columns; zero blocks pointing at block column 0
// pad short block rows.  X is (nbcols * C, k) and Y (nbrows * R, k),
// row-major.
//
// ---------------------------------------------------------------------------
// K12: BSR SpMM.
//
// Replaces krylov_tpu/ops/pallas_bsr.py:bsr_spmm (_kernel).  Bound on this
// card: memory traffic for the block data, R * C values per stored block
// (padding included), read once per tile of up to KRYLOV_BSR_COLS columns;
// X's slabs are shared by the R rows of a block and by the block rows that
// use the same block column, so they come from L1/L2.  The TPU's
// Precision.HIGHEST asks for f32-accurate products, so the kernel
// multiplies with plain FMAs in the data's own type: no TF32, no wgmma.
// Design: one warp per output row (block row i, row r) and column tile of
// KT columns (KT a power of two up to KRYLOV_BSR_COLS, the smallest that
// holds k).  Lane (g, q) = (lane / KT, lane % KT) takes column q of the
// tile and the block columns g, g + 32 / KT, ...; the warp walks the row's
// max_blocks blocks in order.  So each load of X reads 32 / KT slab rows
// of KT consecutive values (coalesced), the block's values are broadcast
// to the KT lanes of a group, and each lane keeps one partial sum.  The
// 32 / KT partials of a column meet in a fixed shuffle tree, and the
// first group's lanes store KT consecutive outputs: the order of every
// sum is fixed, so a product repeats bit for bit.  Two earlier versions
// were slower than the plain einsum somewhere: one thread block per block
// row with chunks staged in shared memory (144-189 us at 256 x 3 blocks
// of 128^2: 256 thread blocks and a barrier per 16 block columns left the
// card latency-bound), and a lane per block column holding all KT sums
// (133.9 us against the plain 103.5 us at 4096 x 3 blocks of 32^2, k = 8,
// on the H100 80GB HBM3 at 700 W: every lane read a 32-byte run of X in
// KT scalar loads and every row paid 5 * KT shuffles; this layout runs
// that product in 82 us).  Instantiated for f32, f64, complex64 and
// complex128.
// ---------------------------------------------------------------------------

#include "krylov_common.cuh"

#define KRYLOV_BSR_COLS 8  // columns of X per tile
#define KRYLOV_BSR_THREADS 256

__device__ __forceinline__ float shfl_down(float v, int o) {
  return __shfl_down_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ double shfl_down(double v, int o) {
  return __shfl_down_sync(0xffffffffu, v, o);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl_down(cplx<R> v, int o) {
  return cplx<R>(shfl_down(v.re, o), shfl_down(v.im, o));
}

template <typename T, int KT>
__global__ void __launch_bounds__(KRYLOV_BSR_THREADS)
bsr_spmm_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                const T* __restrict__ x, T* __restrict__ y, long long nrows,
                int max_blocks, int R, int C, int k) {
  constexpr int G = 32 / KT;  // lane groups, each over every G-th block column
  // the warp index is the same on all 32 lanes, so a warp exits whole
  const long long row = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  if (row >= nrows) return;
  const int lane = threadIdx.x & 31;
  const int q = lane % KT;
  const int g = lane / KT;
  const long long i = row / R;
  const int r = (int)(row - i * R);
  const int col = blockIdx.y * KT + q;
  T acc = T(0);
  if (col < k) {
    // the next block's column is loaded a block ahead, so the X reads,
    // which wait on it, do not stall the start of every block
    int cnext = cols[i * max_blocks];
    for (int b = 0; b < max_blocks; ++b) {
      const long long blk = i * max_blocks + b;
      const int cb = cnext;
      if (b + 1 < max_blocks) cnext = cols[blk + 1];
      const T* arow = data + (blk * R + r) * C;
      const T* xb = x + (long long)cb * C * k + col;
      for (int c = g; c < C; c += G) acc += arow[c] * xb[(long long)c * k];
    }
  }
#pragma unroll
  for (int o = 16; o >= KT; o >>= 1) acc += shfl_down(acc, o);
  if (g == 0 && col < k) y[row * k + col] = acc;
}

template <typename T, int KT>
static void launch_tile(dim3 g, const T* d, const int* cols, const T* xt, T* yt,
                        long long nrows, int max_blocks, int R, int C, int k,
                        cudaStream_t s) {
  bsr_spmm_kernel<T, KT><<<g, KRYLOV_BSR_THREADS, 0, s>>>(d, cols, xt, yt, nrows,
                                                         max_blocks, R, C, k);
}

template <typename T>
static int launch_bsr(const void* data, const int* cols, const void* x, void* y,
                      int nbrows, int max_blocks, int R, int C, int k,
                      cudaStream_t s) {
  const long long nrows = (long long)nbrows * R;
  const long long warps_per_block = KRYLOV_BSR_THREADS / 32;
  const long long gx = (nrows + warps_per_block - 1) / warps_per_block;
  int kt = 1;
  while (kt < k && kt < KRYLOV_BSR_COLS) kt *= 2;
  const long long gy = (k + kt - 1) / kt;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 g((unsigned)gx, (unsigned)gy);
  const T* d = static_cast<const T*>(data);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (kt) {
    case 1: launch_tile<T, 1>(g, d, cols, xt, yt, nrows, max_blocks, R, C, k, s); break;
    case 2: launch_tile<T, 2>(g, d, cols, xt, yt, nrows, max_blocks, R, C, k, s); break;
    case 4: launch_tile<T, 4>(g, d, cols, xt, yt, nrows, max_blocks, R, C, k, s); break;
    default: launch_tile<T, 8>(g, d, cols, xt, yt, nrows, max_blocks, R, C, k, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" {

// K12.  tt: dtype code of data, x and y (f32, f64, c64, c128).
int krylov_bsr_spmm(int tt, const void* data, const int* cols, const void* x,
                    void* y, int nbrows, int max_blocks, int R, int C, int k,
                    void* stream) {
  if (nbrows < 1 || max_blocks < 1 || R < 1 || C < 1 || k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tt) {
    case KRYLOV_F32: return launch_bsr<float>(data, cols, x, y, nbrows, max_blocks, R, C, k, s);
    case KRYLOV_F64: return launch_bsr<double>(data, cols, x, y, nbrows, max_blocks, R, C, k, s);
    case KRYLOV_C64: return launch_bsr<c64>(data, cols, x, y, nbrows, max_blocks, R, C, k, s);
    case KRYLOV_C128: return launch_bsr<c128>(data, cols, x, y, nbrows, max_blocks, R, C, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
