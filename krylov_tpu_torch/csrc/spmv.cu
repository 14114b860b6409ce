// Hand-written Hopper (sm_90a) kernels for general sparsity: CSR SpMV (K10)
// and CSR SpMM (K11).
//
// Plain C interface, loaded with ctypes (krylov_tpu_torch/ops/cuda_spmv.py).
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
//
// Format: CSR with int32 row pointers (n + 1) and int32 column indices, f32
// or bf16 values; x and y are f32 and every sum is taken in f32.  The TPU's
// PET page-ELL format (build_pet, _schedule_slots, the Dekker one-hot
// selection matmuls) exists because Mosaic has a single 128-lane gather;
// Hopper gathers x directly, so the kernels read plain CSR.
//
// L lanes (a power of two up to 32, chosen on the host from the mean row
// length) share a row: lane t takes the row's entries t, t + L, ...  in
// order, and the L partial sums meet in a fixed shuffle tree.  There are no
// atomics, so a product repeats bit for bit.

#include "krylov_common.cuh"

#define KRYLOV_SPMV_THREADS 256
#define KRYLOV_SPMM_COLS 8  // columns of X each row group keeps in registers

template <typename TV>
__device__ __forceinline__ float value_f32(TV v) { return to_acc<float>(v); }

// ---------------------------------------------------------------------------
// K10: CSR SpMV, y = A x.
//
// Replaces krylov_tpu/ops/pallas_spmv.py:pet_matvec (_pet_matvec_padded,
// _pet_kernel).  Bound on this card: memory traffic.  Bytes per call: 8 per
// stored entry for f32 values (value + int32 column; 6 for bf16), 4 per row
// for the row pointers and 4 per row for y, plus x once when the columns
// are local (x's reuse then hits L1/L2).  Design (CSR-vector): L lanes per
// row, so the value and column loads of a row are coalesced L-wide; x is
// read through the read-only cache (__ldg); the L partials are summed by a
// shuffle tree of fixed shape, lane 0 stores.  Each warp holds 32 / L rows,
// so short rows do not leave 31 lanes idle.
// ---------------------------------------------------------------------------
template <int L, typename TV>
__global__ void __launch_bounds__(KRYLOV_SPMV_THREADS)
csr_spmv_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const TV* __restrict__ data, const float* __restrict__ x,
                float* __restrict__ y, int n) {
  const int row = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) / L);
  const int t = threadIdx.x & (L - 1);
  float sum = 0.0f;
  if (row < n) {
    const int end = indptr[row + 1];
    for (int k = indptr[row] + t; k < end; k += L) {
      sum += value_f32(data[k]) * __ldg(x + indices[k]);
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o, L);
  if (row < n && t == 0) y[row] = sum;
}

// ---------------------------------------------------------------------------
// K11: CSR SpMM, Y = A X, X of shape (m, k) row-major, Y (n, k).
//
// Replaces krylov_tpu/ops/pallas_spmv.py:pet_matmat (_pet_matmat_padded,
// _pet_spmm_kernel).  Bound on this card: memory traffic; the index and
// value stream is read once per tile of KRYLOV_SPMM_COLS columns, so its
// cost is shared by those columns.  Design: K10's row groups; in the
// row-major (m, k) layout the columns of one stored entry, X[col, c0:c0+8],
// are contiguous, so each entry reads one value and index and then a short
// contiguous run of X, and the per-column sums stay in registers.  Column
// tiles are the grid's y dimension, so any k takes one launch.  The TPU's
// PET_SPMM_MAX_COLS = 16 and its column-in-lane-major relayout are VMEM
// artifacts and are not carried over.
// ---------------------------------------------------------------------------
template <int L, typename TV>
__global__ void __launch_bounds__(KRYLOV_SPMV_THREADS)
csr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const TV* __restrict__ data, const float* __restrict__ X,
                float* __restrict__ Y, int n, int k) {
  const int row = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) / L);
  const int t = threadIdx.x & (L - 1);
  const int c0 = blockIdx.y * KRYLOV_SPMM_COLS;
  const int nc = min(KRYLOV_SPMM_COLS, k - c0);
  float sum[KRYLOV_SPMM_COLS];
#pragma unroll
  for (int c = 0; c < KRYLOV_SPMM_COLS; ++c) sum[c] = 0.0f;
  if (row < n) {
    const int end = indptr[row + 1];
    for (int e = indptr[row] + t; e < end; e += L) {
      const float a = value_f32(data[e]);
      const float* xr = X + (size_t)indices[e] * k + c0;
#pragma unroll
      for (int c = 0; c < KRYLOV_SPMM_COLS; ++c) {
        if (c < nc) sum[c] += a * __ldg(xr + c);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < KRYLOV_SPMM_COLS; ++c) {
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) sum[c] += __shfl_down_sync(0xffffffffu, sum[c], o, L);
  }
  if (row < n && t == 0) {
    float* yr = Y + (size_t)row * k + c0;
#pragma unroll
    for (int c = 0; c < KRYLOV_SPMM_COLS; ++c) {
      if (c < nc) yr[c] = sum[c];
    }
  }
}

template <typename TV>
static int launch_spmv(int lanes, const int* indptr, const int* indices,
                       const void* data, const float* x, float* y, int n,
                       int k, cudaStream_t s) {
  const long long rows_per_block = KRYLOV_SPMV_THREADS / lanes;
  const long long gx = (n + rows_per_block - 1) / rows_per_block;
  if (gx < 1) return (int)cudaSuccess;
  const TV* d = static_cast<const TV*>(data);
  if (k == 0) {  // K10
    const dim3 g((unsigned)gx);
    switch (lanes) {
      case 1: csr_spmv_kernel<1, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n); break;
      case 2: csr_spmv_kernel<2, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n); break;
      case 4: csr_spmv_kernel<4, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n); break;
      case 8: csr_spmv_kernel<8, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n); break;
      case 16: csr_spmv_kernel<16, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n); break;
      case 32: csr_spmv_kernel<32, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {  // K11
    const long long gy = (k + KRYLOV_SPMM_COLS - 1) / KRYLOV_SPMM_COLS;
    if (gy > 65535) return (int)cudaErrorInvalidValue;
    const dim3 g((unsigned)gx, (unsigned)gy);
    switch (lanes) {
      case 1: csr_spmm_kernel<1, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n, k); break;
      case 2: csr_spmm_kernel<2, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n, k); break;
      case 4: csr_spmm_kernel<4, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n, k); break;
      case 8: csr_spmm_kernel<8, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n, k); break;
      case 16: csr_spmm_kernel<16, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n, k); break;
      case 32: csr_spmm_kernel<32, TV><<<g, KRYLOV_SPMV_THREADS, 0, s>>>(indptr, indices, d, x, y, n, k); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" {

// K10 (k == 0: x of length m, y of length n) and K11 (k >= 1: X (m, k) and
// Y (n, k), row-major).  tv: dtype code of the values (f32 or bf16).
int krylov_csr_spmv(int tv, int lanes, const int* indptr, const int* indices,
                    const void* data, const float* x, float* y, int n, int k,
                    void* stream) {
  if (n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tv == KRYLOV_F32) return launch_spmv<float>(lanes, indptr, indices, data, x, y, n, k, s);
  if (tv == KRYLOV_BF16) {
    return launch_spmv<__nv_bfloat16>(lanes, indptr, indices, data, x, y, n, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
