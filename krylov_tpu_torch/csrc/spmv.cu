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
// There are no atomics: every row's sum is taken in an order fixed by the
// matrix alone, so a product repeats bit for bit.

#include "krylov_common.cuh"

#define KRYLOV_SPMV_THREADS 256
#define KRYLOV_SPMM_COLS 8  // columns of X each row group keeps in registers
// entries each lane of a row's lane group sums, at least, before the row
// gets twice the lanes (K10's row sums out of shared memory)
#ifndef KRYLOV_SPMV_LANE_ENTRIES
#define KRYLOV_SPMV_LANE_ENTRIES 4
#endif

template <typename TV>
__device__ __forceinline__ float value_f32(TV v) { return to_acc<float>(v); }

// Four neighbouring stored values as one streaming load (16 bytes of f32, 8
// of bf16; p aligned to that).
__device__ __forceinline__ void load_values4(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_values4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// ---------------------------------------------------------------------------
// K10: CSR SpMV, y = A x.
//
// Replaces krylov_tpu/ops/pallas_spmv.py:pet_matvec (_pet_matvec_padded,
// _pet_kernel).  Bound on this card: memory traffic.  Bytes per call: 8 per
// stored entry for f32 values (value + int32 column; 6 for bf16), 4 per row
// for the row pointers and 4 per row for y, plus x once when the columns
// are local (x's reuse then hits L1/L2).
//
// Design: stream the entries, not the rows (CSR-stream, Greathouse and Daga
// 2014).  The host cuts the rows once per matrix into runs of whole rows
// that hold at most CAP - 3 stored entries (csr_runs in the wrapper); a
// block takes one run.  Phase 1: the block reads the run's values and
// columns front to back, 16 bytes a thread on neighbouring addresses
// (the run's first entry rounded down to a 16-byte boundary, hence the 3),
// every load of a thread in flight before the first is used, gathers x through
// the read-only cache and leaves the products in shared memory.  Every lane
// does the same work whatever the row lengths, and no load is strided; the
// streamed entries are marked evict-first so that they do not push x out of
// the caches.  Phase 2: rows are summed out of shared memory, a thread a row
// where the run's rows are short (a 5-point matrix: ~800 rows a run), a lane
// group of 2..32 lanes a row where they are long, chosen per run from its
// mean row length; a group's lanes take the row's entries in turn and meet
// in a shuffle tree of fixed shape.  A run of one row (the only run that may
// exceed CAP - 3 entries) is summed by the whole block: a partial a thread,
// then block_sum.  Empty rows write 0.  VEC = false (a base pointer that is
// not 16-byte aligned) reads the entries 4 bytes a thread instead, still on
// neighbouring addresses.  Several blocks share an SM, so one run's row sums
// overlap the next runs' loads.
// ---------------------------------------------------------------------------
template <int VPT, bool VEC, typename TV>
__global__ void __launch_bounds__(KRYLOV_SPMV_THREADS)
csr_stream_kernel(const int* __restrict__ runs, const int* __restrict__ indptr,
                  const int* __restrict__ indices, const TV* __restrict__ data,
                  const float* __restrict__ x, float* __restrict__ y, int nnz) {
  extern __shared__ __align__(16) float prod[];  // 4 * VPT * KRYLOV_SPMV_THREADS products
  const int tid = threadIdx.x;
  const int r0 = runs[blockIdx.x], r1 = runs[blockIdx.x + 1];
  const int e0 = indptr[r0], e1 = indptr[r1];
  if (r1 - r0 == 1) {  // one row, of any length
    float s = 0.0f;
    for (int e = e0 + tid; e < e1; e += KRYLOV_SPMV_THREADS) {
      s += value_f32(data[e]) * __ldg(x + indices[e]);
    }
    s = block_sum(s);
    if (tid == 0) y[r0] = s;
    return;
  }
  const int base = VEC ? (e0 & ~3) : e0;  // prod[k] holds entry base + k
  if (VEC) {
    int col[VPT][4];
    float val[VPT][4];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int a = base + (i * KRYLOV_SPMV_THREADS + tid) * 4;
      if (a + 4 <= nnz && a < e1) {
        const int4 c = __ldcs(reinterpret_cast<const int4*>(indices + a));
        col[i][0] = c.x; col[i][1] = c.y; col[i][2] = c.z; col[i][3] = c.w;
        load_values4(data + a, val[i]);
      } else {  // past the run, or the array's last, short quad
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool in = a + k < e1;
          col[i][k] = in ? indices[a + k] : 0;
          val[i][k] = in ? value_f32(data[a + k]) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int a = base + (i * KRYLOV_SPMV_THREADS + tid) * 4;
      if (a < e1) {
        float4 p;
        p.x = val[i][0] * __ldg(x + col[i][0]);
        p.y = val[i][1] * __ldg(x + col[i][1]);
        p.z = val[i][2] * __ldg(x + col[i][2]);
        p.w = val[i][3] * __ldg(x + col[i][3]);
        *reinterpret_cast<float4*>(prod + (a - base)) = p;
      }
    }
  } else {
    int col[4 * VPT];
    float val[4 * VPT];
#pragma unroll
    for (int i = 0; i < 4 * VPT; ++i) {
      const int e = base + i * KRYLOV_SPMV_THREADS + tid;
      col[i] = e < e1 ? indices[e] : 0;
      val[i] = e < e1 ? value_f32(data[e]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4 * VPT; ++i) {
      const int e = base + i * KRYLOV_SPMV_THREADS + tid;
      if (e < e1) prod[e - base] = val[i] * __ldg(x + col[i]);
    }
  }
  __syncthreads();
  const int mean = (e1 - e0) / (r1 - r0);
  int G = 1;  // lanes a row
  while (G < 32 && 2 * G * KRYLOV_SPMV_LANE_ENTRIES <= mean) G *= 2;
  const int lane = tid & (G - 1);
  for (int rb = r0; rb < r1; rb += KRYLOV_SPMV_THREADS / G) {  // uniform: the shuffles need every lane
    const int row = rb + tid / G;
    float s = 0.0f;
    if (row < r1) {
      const int end = indptr[row + 1] - base;
      for (int k = indptr[row] - base + lane; k < end; k += G) s += prod[k];
    }
    for (int o = G / 2; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o, G);
    if (row < r1 && lane == 0) y[row] = s;
  }
}

template <int VPT, typename TV>
static void launch_stream(bool vec, int nruns, const int* runs, const int* indptr,
                          const int* indices, const TV* data, const float* x,
                          float* y, int nnz, cudaStream_t s) {
  const size_t smem = (size_t)4 * VPT * KRYLOV_SPMV_THREADS * sizeof(float);
  if (vec) {
    csr_stream_kernel<VPT, true, TV><<<nruns, KRYLOV_SPMV_THREADS, smem, s>>>(
        runs, indptr, indices, data, x, y, nnz);
  } else {
    csr_stream_kernel<VPT, false, TV><<<nruns, KRYLOV_SPMV_THREADS, smem, s>>>(
        runs, indptr, indices, data, x, y, nnz);
  }
}

template <typename TV>
static int launch_stream_for(int capacity, int nruns, const int* runs, const int* indptr,
                             const int* indices, const void* data, const float* x,
                             float* y, int nnz, cudaStream_t s) {
  const TV* d = static_cast<const TV*>(data);
  // the 16-byte loads need the column array on a 16-byte boundary and the
  // value array on one of four values
  const bool vec = reinterpret_cast<uintptr_t>(indices) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(data) % (4 * sizeof(TV)) == 0;
  switch (capacity) {
    case 1024: launch_stream<1, TV>(vec, nruns, runs, indptr, indices, d, x, y, nnz, s); break;
    case 2048: launch_stream<2, TV>(vec, nruns, runs, indptr, indices, d, x, y, nnz, s); break;
    case 4096: launch_stream<4, TV>(vec, nruns, runs, indptr, indices, d, x, y, nnz, s); break;
    case 8192: launch_stream<8, TV>(vec, nruns, runs, indptr, indices, d, x, y, nnz, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11: CSR SpMM, Y = A X, X of shape (m, k) row-major, Y (n, k).
//
// Replaces krylov_tpu/ops/pallas_spmv.py:pet_matmat (_pet_matmat_padded,
// _pet_spmm_kernel).  Bound on this card: memory traffic; the index and
// value stream is read once per tile of KRYLOV_SPMM_COLS columns, so its
// cost is shared by those columns.  Design: L lanes (a power of two up to
// 32, chosen on the host from the mean row length) share a row: lane t takes
// the row's entries t, t + L, ... in order, and the L partial sums meet in a
// fixed shuffle tree; in the row-major (m, k) layout the columns of one
// stored entry, X[col, c0:c0+8], are contiguous, so each entry reads one
// value and index and then a short contiguous run of X, and the per-column
// sums stay in registers.  Column
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
static int launch_spmm(int lanes, const int* indptr, const int* indices,
                       const void* data, const float* x, float* y, int n,
                       int k, cudaStream_t s) {
  const long long rows_per_block = KRYLOV_SPMV_THREADS / lanes;
  const long long gx = (n + rows_per_block - 1) / rows_per_block;
  if (gx < 1) return (int)cudaSuccess;
  const TV* d = static_cast<const TV*>(data);
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
  return (int)cudaGetLastError();
}

extern "C" {

// K10: x of length m, y of length n.  tv: dtype code of the values (f32 or
// bf16).  runs: nruns + 1 first rows of the runs (runs[0] = 0, runs[nruns]
// = n), each run whole rows with at most capacity - 3 stored entries unless
// it is a single row; capacity: 1024, 2048, 4096 or 8192 products of shared
// memory a block.  nnz: the length of indices and data.
int krylov_csr_spmv(int tv, int capacity, int nruns, const int* runs,
                    const int* indptr, const int* indices, const void* data,
                    const float* x, float* y, int nnz, void* stream) {
  if (nruns < 0 || nnz < 0) return (int)cudaErrorInvalidValue;
  if (nruns == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tv == KRYLOV_F32) {
    return launch_stream_for<float>(capacity, nruns, runs, indptr, indices, data, x, y, nnz, s);
  }
  if (tv == KRYLOV_BF16) {
    return launch_stream_for<__nv_bfloat16>(capacity, nruns, runs, indptr, indices, data, x, y,
                                            nnz, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K11: X (m, k) and Y (n, k), row-major, k >= 1; lanes: a power of two up
// to 32.
int krylov_csr_spmm(int tv, int lanes, const int* indptr, const int* indices,
                    const void* data, const float* x, float* y, int n, int k,
                    void* stream) {
  if (n < 0 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tv == KRYLOV_F32) return launch_spmm<float>(lanes, indptr, indices, data, x, y, n, k, s);
  if (tv == KRYLOV_BF16) {
    return launch_spmm<__nv_bfloat16>(lanes, indptr, indices, data, x, y, n, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
